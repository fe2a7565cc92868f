// Catalog scoring fused with a group-max reduction, for Hopper (sm_90a).
//
// Replaces: sbr_rs_tpu/ops/pallas_topk.py:_groupmax_kernel (score_groupmax)
// and :_submax_groupmax_kernel (score_submax_groupmax), phase 1 of the
// exact two-phase top-k. For table rows [c, cc] (f32, or bf16 upcast on
// load) and bias-augmented user representations reps [u, cc] (f32):
//   s[i, u]  = sum_k rows[i, k] * reps[u, k]
//   s[i, u]  = -inf unless (lo + i < n) and (i < c)
//   out1[g, u] = max of s over rows [g*w1, (g+1)*w1)
//   out2[g, u] = max of s over rows [g*w2, (g+1)*w2)   (two-output variant)
// Both outputs carry round_up(c, 2048) / width rows, the rows past c all
// -inf: the row contract of the TPU functions (groupmax_rows), which the
// serving dispatch relies on.
//
// What bounds it on the H100: arithmetic. At the serving shape (10M rows x
// 4096 users x 128) one call is 10.5 TFLOP, done in FP32 FMAs; the table is
// 5.12 GB and is read from HBM about once (the user tiles of one row block
// run next to each other and hit it in L2). Tensor cores and TF32 are not
// used: phase 1's maxima must bound the f32 scores phase 2 recomputes.
//
// Design: a plain shared-memory tiled SGEMM. A block scores a 128-row by
// 128-user tile in 8-deep slices of cc; each of its 256 threads keeps an
// 8 x 8 register tile (8 consecutive rows x 8 users strided by 16). The
// score tile never leaves the SM: each thread masks and max-reduces its 8
// rows, the 16 partial maxima of a column meet in shared memory, and the
// block writes 128/w maxima per user for each width w (w in {8, ..., 128}
// divides the 128-row tile, so no group spans two blocks). Loads are
// bounded by c and cc (a ragged last block reads no row past c), and every
// offset into the table and the outputs is 64-bit (the 10M-row subgroup
// stack has 1.28e9 elements, a 20M one more than 2^31).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // table rows per block
constexpr int BN = 128;  // users per block
constexpr int BK = 8;    // slice of cc staged in shared memory
constexpr int TM = 8;    // consecutive rows per thread
constexpr int TN = 8;    // users per thread, strided by BN / TN
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256
constexpr int kRowBlock = 2048;  // output padding unit (the TPU row block)

__device__ __forceinline__ float load_row(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_row(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Maxima of width w over this block's rows from the per-thread 8-row maxima
// in red, written to out rows [r0 / w, r0 / w + BM / w).
__device__ __forceinline__ void write_maxima(float (*red)[BN + 16],
                                             float* __restrict__ out, int w,
                                             int64_t r0, int u0, int u) {
  const int per = w / TM;
  const int outs = BM / w;
  const int64_t orow0 = r0 / w;
  for (int e = threadIdx.x; e < outs * BN; e += kThreads) {
    const int s = e / BN;
    const int col = e % BN;
    const int uu = u0 + col;
    if (uu >= u) continue;
    float v = red[s * per][col];
    for (int q = 1; q < per; ++q) v = fmaxf(v, red[s * per + q][col]);
    out[(orow0 + s) * static_cast<int64_t>(u) + uu] = v;
  }
}

template <typename RowT, bool kTwo>
__global__ void __launch_bounds__(kThreads)
    score_groupmax_kernel(const RowT* __restrict__ rows,
                          const float* __restrict__ reps,
                          float* __restrict__ out1, float* __restrict__ out2,
                          int64_t c, int cc, int u, int64_t lo, int64_t n,
                          int w1, int w2) {
  __shared__ __align__(16) float As[BK][BM + 4];  // rows slice, transposed
  __shared__ float Bs[BK][BN + 4];                // reps slice, transposed
  __shared__ float red[BM / TM][BN + 16];         // per-thread 8-row maxima

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  // User tiles of one row block are neighbours in launch order, so the row
  // block is fetched from HBM once and re-read from L2.
  const int n_user_tiles = (u + BN - 1) / BN;
  const int64_t bid = blockIdx.x;
  const int64_t r0 = (bid / n_user_tiles) * BM;
  const int u0 = static_cast<int>(bid % n_user_tiles) * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < cc; k0 += BK) {
#pragma unroll
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int m = e / BK;
      const int k = e % BK;
      const int64_t row = r0 + m;
      float v = 0.0f;
      if (row < c && k0 + k < cc) v = load_row(rows + row * cc + k0 + k);
      As[k][m] = v;
    }
#pragma unroll
    for (int e = tid; e < BN * BK; e += kThreads) {
      const int m = e / BK;
      const int k = e % BK;
      const int uu = u0 + m;
      Bs[k][m] = (uu < u && k0 + k < cc)
                     ? __ldg(reps + static_cast<int64_t>(uu) * cc + k0 + k)
                     : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&As[k][ty * TM + 4]);
      const float a[TM] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                           a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      float b[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[k][tx + j * (BN / TN)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Mask (both bounds, as on the TPU) and reduce this thread's 8 rows.
  float m[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) m[j] = -INFINITY;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t local = r0 + ty * TM + i;
    if (local < c && lo + local < n) {
#pragma unroll
      for (int j = 0; j < TN; ++j) m[j] = fmaxf(m[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) red[ty][tx + j * (BN / TN)] = m[j];
  __syncthreads();

  write_maxima(red, out1, w1, r0, u0, u);
  if constexpr (kTwo) write_maxima(red, out2, w2, r0, u0, u);
}

template <typename RowT>
int launch(const RowT* rows, const float* reps, float* out1, float* out2,
           long long c, int cc, int u, long long lo, long long n, int w1,
           int w2, int two, cudaStream_t stream) {
  const long long row_blocks = (c + kRowBlock - 1) / kRowBlock * (kRowBlock / BM);
  const long long blocks = row_blocks * ((u + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (blocks > 0) {
    if (two) {
      score_groupmax_kernel<RowT, true><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
          rows, reps, out1, out2, c, cc, u, lo, n, w1, w2);
    } else {
      score_groupmax_kernel<RowT, false><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
          rows, reps, out1, out2, c, cc, u, lo, n, w1, w2);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows [c, cc] (row-major, contiguous), reps [u, cc] f32, out1
// [round_up(c, 2048) / w1, u] f32 and, when two != 0, out2
// [round_up(c, 2048) / w2, u] f32. w1, w2 in {8, 16, 32, 64, 128}.
extern "C" int sbr_score_groupmax_f32(const float* rows, const float* reps,
                                      float* out1, float* out2, long long c,
                                      int cc, int u, long long lo, long long n,
                                      int w1, int w2, int two,
                                      cudaStream_t stream) {
  return launch(rows, reps, out1, out2, c, cc, u, lo, n, w1, w2, two, stream);
}

extern "C" int sbr_score_groupmax_bf16(const __nv_bfloat16* rows,
                                       const float* reps, float* out1,
                                       float* out2, long long c, int cc, int u,
                                       long long lo, long long n, int w1,
                                       int w2, int two, cudaStream_t stream) {
  return launch(rows, reps, out1, out2, c, cc, u, lo, n, w1, w2, two, stream);
}
