// HSTU's two layer norms a block, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no HSTU. It was added because
// PyTorch's layer norm takes its non-vectorised path for rows whose width is
// not a multiple of 4 (HSTU-large's 50), one 512-thread block a row, and
// that took about 40 % of the HSTU tower's device time. Without affine, with
// the biased variance and rsqrt(var + eps), in fp32 (as
// torch.nn.functional.layer_norm):
//   pre-norm:    out[r, :] = LN(x[r, :])                  x, out [R, D]
//   gated norm:  out[r, :] = u[r, :] * LN(o[b, :, t, :])  r = b T + t
// where o [B, H, T, hd] is the attention's output as the batched product
// A V leaves it (the row of position t is the concatenation of its H heads;
// the transposing copy is never made), u [R, D] is a view with unit column
// stride and row stride su (U of the split of SiLU(n W_uvqk), su = 4 D), and
// out [R, D] is contiguous. D = H hd <= 256. A row's result depends on that
// row alone.
//
// What bounds it on the H100: bytes. At the HSTU cell's shape (R = 8,192 x
// 200 rows of 50 floats) a pre-norm moves 655 MB and a gated norm 983 MB:
// 0.20 and 0.29 ms at 3.35 TB/s, with a few FLOPs an element.
//
// Design. A block streams a tile of consecutive rows of one sequence b
// through shared memory: a row of 50 floats is 200 bytes, so only every
// other row starts on a 16-byte boundary, and a lane or a block a row would
// load it in pieces. A tile starts at a multiple of 4 rows, so each head's
// slice of it (the tile's rows x hd floats, contiguous in o) and the output
// tile (rows x D floats) are whole runs of 16-byte words wherever the
// pointers are 16-byte aligned and T hd is a multiple of 4; else the kernel
// moves single floats, still coalesced. In shared memory the tile is laid
// out by rows; eight lanes reduce a row (mean, then the squared deviations
// from the row they hold in registers) by shuffles, and write it back
// normalised; then the block stores the tile, multiplying each element by
// its u, read coalesced, in the gated mode. The tile's rows are chosen on
// the host so that tiles of about equal size cover each sequence.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;             // lanes that reduce one row
constexpr int kTileFloats = 4096;     // shared memory of a tile: 16 KB
constexpr int kMaxD = 256;

template <int kPer, bool kGate, bool kVec>
__global__ void __launch_bounds__(kThreads)
    hstu_norm_kernel(const float* __restrict__ x, const float* __restrict__ u, long long su,
                     float* __restrict__ out, int h_count, long long t_len, int hd, int tile_rows,
                     long long tiles_per_seq, float eps) {
  __shared__ __align__(16) float s[kTileFloats];
  const int tid = threadIdx.x;
  const int d = h_count * hd;
  const long long b = blockIdx.x / tiles_per_seq;
  const long long t0 = (blockIdx.x % tiles_per_seq) * tile_rows;
  const int n = static_cast<int>(t_len - t0 < tile_rows ? t_len - t0 : tile_rows);
  const long long row0 = b * t_len + t0;

  // Load: each head's slice is n x hd contiguous floats of x.
  for (int h = 0; h < h_count; ++h) {
    const float* src = x + ((b * h_count + h) * t_len + t0) * hd;
    float* dst = s + h * hd;
    const int cnt = n * hd;
    int e0 = 0;
    if constexpr (kVec) {
      const int nq = cnt / 4;
      for (int q = tid; q < nq; q += kThreads) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(src) + q);
        const float w[4] = {v.x, v.y, v.z, v.w};
        int r = (4 * q) / hd;
        int j = 4 * q - r * hd;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          dst[r * d + j] = w[k];
          if (++j == hd) {
            j = 0;
            ++r;
          }
        }
      }
      e0 = 4 * nq;
    }
    for (int e = e0 + tid; e < cnt; e += kThreads) {
      const int r = e / hd;
      dst[r * d + e - r * hd] = __ldg(src + e);
    }
  }
  __syncthreads();

  // Normalise: eight lanes a row, the row in registers.
  const int lane = tid % kLanes;
  for (int r0 = 0; r0 < n; r0 += kThreads / kLanes) {
    const int r = r0 + tid / kLanes;
    const bool live = r < n;
    float v[kPer];
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = lane + kLanes * k;
      v[k] = live && j < d ? s[r * d + j] : 0.0f;
      sum += v[k];
    }
#pragma unroll
    for (int m = kLanes / 2; m > 0; m /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, m);
    const float mean = sum / d;
    float sq = 0.0f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const float c = v[k] - mean;
      if (lane + kLanes * k < d) sq += c * c;
    }
#pragma unroll
    for (int m = kLanes / 2; m > 0; m /= 2) sq += __shfl_xor_sync(0xffffffffu, sq, m);
    const float rstd = rsqrtf(sq / d + eps);
    if (live) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int j = lane + kLanes * k;
        if (j < d) s[r * d + j] = (v[k] - mean) * rstd;
      }
    }
  }
  __syncthreads();

  // Store the tile: n x D contiguous floats of out.
  float* dst = out + row0 * d;
  const int cnt = n * d;
  if constexpr (kGate) {
    for (int e = tid; e < cnt; e += kThreads) {
      const int r = e / d;
      dst[e] = s[e] * __ldg(u + (row0 + r) * su + (e - r * d));
    }
  } else {
    int e0 = 0;
    if constexpr (kVec) {
      const int nq = cnt / 4;
      for (int q = tid; q < nq; q += kThreads) {
        reinterpret_cast<float4*>(dst)[q] = reinterpret_cast<const float4*>(s)[q];
      }
      e0 = 4 * nq;
    }
    for (int e = e0 + tid; e < cnt; e += kThreads) dst[e] = s[e];
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int kPer, bool kGate>
void launch_per(unsigned int blocks, bool vec, const float* x, const float* u, long long su,
                float* out, int h_count, long long t_len, int hd, int tile_rows,
                long long tiles_per_seq, float eps, cudaStream_t stream) {
  if (vec) {
    hstu_norm_kernel<kPer, kGate, true><<<blocks, kThreads, 0, stream>>>(
        x, u, su, out, h_count, t_len, hd, tile_rows, tiles_per_seq, eps);
  } else {
    hstu_norm_kernel<kPer, kGate, false><<<blocks, kThreads, 0, stream>>>(
        x, u, su, out, h_count, t_len, hd, tile_rows, tiles_per_seq, eps);
  }
}

// x as B sequences of H heads of [T, hd]; out [B T, H hd]; u (gated) [B T,
// H hd] at row stride su.
template <bool kGate>
int launch(const float* x, const float* u, long long su, float* out, long long seqs, int h_count,
           long long t_len, int hd, float eps, cudaStream_t stream) {
  const int d = h_count * hd;
  if (seqs < 0 || t_len < 0 || h_count < 1 || hd < 1 || d > kMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (seqs == 0 || t_len == 0) return static_cast<int>(cudaGetLastError());
  // The most rows a tile holds, a multiple of 4 (16 at D = 256), then tiles
  // of about equal size over a sequence.
  const long long max_rows = kTileFloats / d / 4 * 4;
  const long long tiles = (t_len + max_rows - 1) / max_rows;
  const long long rows = ((t_len + tiles - 1) / tiles + 3) / 4 * 4;
  const long long tiles_per_seq = (t_len + rows - 1) / rows;
  const long long blocks = seqs * tiles_per_seq;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec = aligned16(x) && aligned16(out) && (seqs * h_count == 1 || t_len * hd % 4 == 0);
  const unsigned int grid = static_cast<unsigned int>(blocks);
  const int tile_rows = static_cast<int>(rows);
  if (d <= 4 * kLanes) {
    launch_per<4, kGate>(grid, vec, x, u, su, out, h_count, t_len, hd, tile_rows, tiles_per_seq, eps, stream);
  } else if (d <= 8 * kLanes) {
    launch_per<8, kGate>(grid, vec, x, u, su, out, h_count, t_len, hd, tile_rows, tiles_per_seq, eps, stream);
  } else if (d <= 16 * kLanes) {
    launch_per<16, kGate>(grid, vec, x, u, su, out, h_count, t_len, hd, tile_rows, tiles_per_seq, eps, stream);
  } else {
    launch_per<32, kGate>(grid, vec, x, u, su, out, h_count, t_len, hd, tile_rows, tiles_per_seq, eps, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [rows, d] contiguous, out [rows, d] contiguous; d <= 256.
extern "C" int sbr_hstu_norm_f32(const float* x, float* out, long long rows, int d, float eps,
                                 cudaStream_t stream) {
  return launch<false>(x, nullptr, 0, out, 1, 1, rows, d, eps, stream);
}

// o [seqs, h_count, t_len, hd] contiguous; u [seqs t_len, h_count hd] with
// unit column stride and row stride su; out [seqs t_len, h_count hd]
// contiguous; h_count hd <= 256.
extern "C" int sbr_hstu_gated_norm_f32(const float* u, long long su, const float* o, float* out,
                                       long long seqs, int h_count, long long t_len, int hd,
                                       float eps, cudaStream_t stream) {
  return launch<true>(o, u, su, out, seqs, h_count, t_len, hd, eps, stream);
}
