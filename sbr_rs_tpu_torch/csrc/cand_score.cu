// WARP's candidate gather + score, for Hopper (sm_90a).
//
// Replaces: scripts/cand_gather_probe.py:_make_vmem (P3, the table resident
// on chip) and :pallas_dma_rows (P4, rows fetched one by one from HBM), the
// Pallas probes of the training step's candidate scoring
// (sbr_rs_tpu/models/engine.py, cand_score). For bias-augmented hidden
// states haug [p, c] (f32), a table [n, c] (f32, or bf16 upcast on load)
// and candidate ids cand [p, k] (int64):
//   out[i, q] = sum_e haug[i, e] * table[clamp(cand[i, q], 0, n - 1), e]   out [p, k] f32
// in FP32 FMAs only (no TF32): WARP compares these scores with the positive
// score at a margin of 1, and the selection should not move with the
// precision of the product.
//
// What bounds it on the H100: bytes. At items10m's shape (16,384 positions x
// 5 candidates of a 10M x 128 f32 table) the candidate rows are 41.9 MB and
// the hidden states 8.4 MB: about 15 us at 3.35 TB/s, for 21 MFLOP. The
// [p, k, c] candidate rows are never written: the TPU formulation (take +
// einsum) wrote and re-read them.
//
// Design.
// * cand_score_rows (P4): one warp per position. Its haug row lives in
//   registers (up to 512 columns, 16 floats a lane; a wider row is re-read
//   from L1 for each candidate); each candidate row is read straight from
//   global memory, 16 bytes a lane where the width and pointers allow it,
//   and the lane partials meet in a shuffle reduction.
// * cand_score_smem (P3): the whole table is staged in each block's dynamic
//   shared memory (at most the 227 KB a block can opt in to) by the
//   bulk-copy engine (cp.async.bulk, completing an mbarrier): the table sits
//   there at the same address mod 16 as in device memory, so the copy starts
//   at its first 16-byte boundary, and the < 16 bytes on either side go by
//   plain loads. Then one thread per candidate score walks the table row
//   (rows up to kThreadC columns whose stride is an odd number of 4-byte
//   banks, as fit-bench's 33 floats; other rows: one warp per position,
//   lane-strided reads, conflict-free for any stride). The grid is one block
//   per 512 scores (per 16 positions where warps score), at most one per SM.
//   What bounds it: every block pulls the whole table out of L2 (fit-bench's
//   222 KB to 80 blocks is 17.8 MB), and the bytes L2 can deliver to the SMs
//   set the staging's time, so the grid is sized by the scores (one per
//   thread), not by the SMs. (Staging by .multicast::cluster bulk copies,
//   one read of the table per thread-block cluster, measured slower on the
//   H100 at every cluster size: PERF.md.)
//   One thread per score, not one warp: a warp per position spends five
//   dependent shuffle reductions a position and was the larger cost at
//   fit-bench's shape.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 512;        // columns a warp keeps in registers
constexpr int kRowsWarps = 8;     // warps per block, cand_score_rows
constexpr int kSmemThreads = 512; // threads per block, cand_score_smem
constexpr int kThreadC = 128;     // widest row scored by one thread, cand_score_smem

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int V>
__device__ __forceinline__ void load_v(const T* p, float* v) {
  if constexpr (V == 1) {
    v[0] = to_f32(*p);
  } else if constexpr (sizeof(T) == 4) {  // V == 4 floats
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {  // V == 8 bf16
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h[q]);
      v[2 * q] = f.x;
      v[2 * q + 1] = f.y;
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ int64_t clamp_row(int64_t r, int64_t n) {
  return r < 0 ? 0 : (r > n - 1 ? n - 1 : r);
}

// Rows wider than kMaxC: the same lane-strided sums, haug read per candidate.
template <typename T>
__device__ __forceinline__ void score_wide(const float* hp, const T* table,
                                           const int64_t* cand, float* out,
                                           int64_t n, int c, int k, int lane) {
  for (int q = 0; q < k; ++q) {
    const T* row = table + clamp_row(__ldg(cand + q), n) * c;
    float acc = 0.0f;
    for (int col = lane; col < c; col += 32) acc = fmaf(hp[col], to_f32(row[col]), acc);
    acc = warp_sum(acc);
    if (lane == 0) out[q] = acc;
  }
}

// Lane `lane` holds columns (s * 32 + lane) * V .. + V - 1 of its position's
// haug row, for s < kMaxC / (32 * V); columns past c hold 0.
template <int V>
__device__ __forceinline__ void load_haug(const float* hp, int c, int lane,
                                          float (&h)[kMaxC / (32 * V)][V]) {
#pragma unroll
  for (int s = 0; s < kMaxC / (32 * V); ++s) {
    const int col = (s * 32 + lane) * V;
    if (col < c) {
#pragma unroll
      for (int e = 0; e < V; e += (V == 1 ? 1 : 4)) load_v<float, (V == 1 ? 1 : 4)>(hp + col + e, &h[s][e]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) h[s][e] = 0.0f;
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(32 * kRowsWarps)
    cand_score_rows_kernel(const float* __restrict__ haug, const T* __restrict__ table,
                           const int64_t* __restrict__ cand, float* __restrict__ out,
                           int64_t n, int64_t p, int c, int k) {
  const int64_t pos = static_cast<int64_t>(blockIdx.x) * kRowsWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (pos >= p) return;
  if (c > kMaxC) {
    score_wide(haug + pos * c, table, cand + pos * k, out + pos * k, n, c, k, lane);
    return;
  }
  constexpr int S = kMaxC / (32 * V);
  float h[S][V];
  load_haug<V>(haug + pos * c, c, lane, h);
  for (int q = 0; q < k; ++q) {
    const T* row = table + clamp_row(__ldg(cand + pos * k + q), n) * c;
    float acc = 0.0f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int col = (s * 32 + lane) * V;
      if (col < c) {
        float v[V];
        load_v<T, V>(row + col, v);
#pragma unroll
        for (int e = 0; e < V; ++e) acc = fmaf(h[s][e], v[e], acc);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) out[pos * k + q] = acc;
  }
}

// Shared memory of P3: the mbarrier, padded to 128 bytes, then the table,
// placed at kBarBytes + (table address mod 16) so that a 16-byte boundary of
// the table in device memory is one in shared memory too. A table on a
// 16-byte boundary (as torch allocates) is then copied to a 128-byte line of
// shared memory: at 16 bytes past one, P3 at fit-bench's shape took 1.7x as
// long on the H100 (PERF.md).
constexpr int kBarBytes = 128;

__host__ __device__ inline size_t smem_table_bytes(long long n, int c, int itemsize) {
  return kBarBytes + 16 + static_cast<size_t>(n) * c * itemsize;
}

// One thread per score when the row is narrow and its stride in shared
// memory is an odd number of 4-byte banks (or not a whole number of them), so
// that threads reading the same column of different rows spread over the
// banks; else one warp per position, whose lane-strided reads of one row
// never conflict (a 32-float row stride would put a warp's 32 rows in one
// bank).
__host__ __device__ inline bool per_thread_scores(int c, int itemsize) {
  return c <= kThreadC && (static_cast<long long>(c) * itemsize) % 8 != 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

template <typename T>
__global__ void __launch_bounds__(kSmemThreads)
    cand_score_smem_kernel(const float* __restrict__ haug, const T* __restrict__ table,
                           const int64_t* __restrict__ cand, float* __restrict__ out,
                           int64_t n, int64_t p, int c, int k) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  const unsigned char* src = reinterpret_cast<const unsigned char*>(table);
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(src) % 16);
  unsigned char* dst = smem_raw + kBarBytes + shift;
  const T* tab = reinterpret_cast<const T*>(dst);

  // Bytes [head, tail) go by one bulk copy of whole 16-byte units; the < 16
  // bytes on either side by plain loads.
  const int64_t bytes = n * c * static_cast<int64_t>(sizeof(T));
  const int64_t head = (16 - shift) % 16 < bytes ? (16 - shift) % 16 : bytes;
  const int64_t tail = head + 16 * ((bytes - head) / 16);
  if (threadIdx.x == 0) {
    const uint32_t size = static_cast<uint32_t>(tail - head);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(size)
                 : "memory");
    if (size > 0)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
              smem_u32(dst + head)),
          "l"(src + head), "r"(size), "r"(smem_u32(bar))
          : "memory");
  }
  for (int64_t e = threadIdx.x; e < head + (bytes - tail); e += kSmemThreads) {
    const int64_t at = e < head ? e : tail + (e - head);
    dst[at] = src[at];
  }
  __syncthreads();  // the barrier initialised, the plain-load bytes in place

  if (per_thread_scores(c, sizeof(T))) {
    // One thread per score d = pos * k + q; its candidate id is loaded a
    // score ahead (the first while the table lands).
    const int64_t dots = p * k;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kSmemThreads;
    int64_t d = static_cast<int64_t>(blockIdx.x) * kSmemThreads + threadIdx.x;
    int64_t id = d < dots ? __ldg(cand + d) : 0;
    mbar_wait(bar, 0);
    for (; d < dots; d += stride) {
      const T* row = tab + clamp_row(id, n) * c;
      const float* hp = haug + (d / k) * c;
      if (d + stride < dots) id = __ldg(cand + d + stride);
      float acc = 0.0f;
#pragma unroll 4
      for (int col = 0; col < c; ++col) acc = fmaf(__ldg(hp + col), to_f32(row[col]), acc);
      out[d] = acc;
    }
  } else {
    // One warp per position, lane-strided.
    constexpr int kWarps = kSmemThreads / 32;
    const int lane = threadIdx.x % 32;
    mbar_wait(bar, 0);
    for (int64_t pos = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32; pos < p;
         pos += static_cast<int64_t>(gridDim.x) * kWarps)
      score_wide(haug + pos * c, tab, cand + pos * k, out + pos * k, n, c, k, lane);
  }
}

template <typename T>
int launch_rows(const float* haug, const T* table, const int64_t* cand, float* out,
                long long n, long long p, int c, int k, int vec, cudaStream_t stream) {
  const long long blocks = (p + kRowsWarps - 1) / kRowsWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    const unsigned int g = static_cast<unsigned int>(blocks);
    constexpr int V = sizeof(T) == 4 ? 4 : 8;
    if (vec) {
      cand_score_rows_kernel<T, V><<<g, 32 * kRowsWarps, 0, stream>>>(haug, table, cand, out, n, p, c, k);
    } else {
      cand_score_rows_kernel<T, 1><<<g, 32 * kRowsWarps, 0, stream>>>(haug, table, cand, out, n, p, c, k);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_smem(const float* haug, const T* table, const int64_t* cand, float* out,
                long long n, long long p, int c, int k, cudaStream_t stream) {
  const size_t smem = smem_table_bytes(n, c, sizeof(T));
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  // One block per kSmemThreads scores (per kSmemThreads / 32 positions for
  // rows a warp scores), at most one per SM: each block stages the whole
  // table, and the blocks stride over the rest.
  const long long want = per_thread_scores(c, sizeof(T)) ? (p * k + kSmemThreads - 1) / kSmemThreads
                                                         : (p + kSmemThreads / 32 - 1) / (kSmemThreads / 32);
  if (want == 0) return static_cast<int>(cudaSuccess);
  auto kernel = cand_score_smem_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int grid = static_cast<unsigned int>(want < sms ? want : sms);
  kernel<<<grid, kSmemThreads, smem, stream>>>(haug, table, cand, out, static_cast<int64_t>(n),
                                               static_cast<int64_t>(p), c, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// haug [p, c] f32, table [n, c], cand [p, k] int64, out [p, k] f32.
// vec != 0: c is a multiple of 4 (f32) or 8 (bf16), and haug and table are
// 16-byte aligned.
extern "C" int sbr_cand_score_rows_f32(const float* haug, const float* table, const int64_t* cand,
                                       float* out, long long n, long long p, int c, int k, int vec,
                                       cudaStream_t stream) {
  return launch_rows(haug, table, cand, out, n, p, c, k, vec, stream);
}

extern "C" int sbr_cand_score_rows_bf16(const float* haug, const __nv_bfloat16* table,
                                        const int64_t* cand, float* out, long long n, long long p,
                                        int c, int k, int vec, cudaStream_t stream) {
  return launch_rows(haug, table, cand, out, n, p, c, k, vec, stream);
}

// As above, with the whole table staged in shared memory: kBarBytes + 16 +
// n * c * itemsize must fit the device's opt-in limit per block (232,448
// bytes on the H100).
extern "C" int sbr_cand_score_smem_f32(const float* haug, const float* table, const int64_t* cand,
                                       float* out, long long n, long long p, int c, int k,
                                       cudaStream_t stream) {
  return launch_smem(haug, table, cand, out, n, p, c, k, stream);
}

extern "C" int sbr_cand_score_smem_bf16(const float* haug, const __nv_bfloat16* table,
                                        const int64_t* cand, float* out, long long n, long long p,
                                        int c, int k, cudaStream_t stream) {
  return launch_smem(haug, table, cand, out, n, p, c, k, stream);
}
