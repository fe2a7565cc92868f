// Catalog scoring fused with a per-user rank count, for Hopper (sm_90a).
//
// Replaces: sbr_rs_tpu/ops/pallas_topk.py:_count_kernel (score_count_ge),
// the fused counter of the streamed MRR evaluation. For table rows [c, cc]
// (f32, or bf16 upcast on load), bias-augmented user representations
// reps [u, cc] (f32), targets [u] (f32) and probe rows probe [u] (int64):
//   s[i, u]       = sum_k rows[i, k] * reps[u, k]
//   counts[u]     = #{ i : lo + i < n, i >= col_lo, i < c, s[i, u] >= targets[u] }
//   probe_out[u]  = s[clamp(probe[u], 0, c - 1), u]
// counts must be zero on entry (the wrapper zeroes it); probe_out is written
// exactly once per user.
//
// What bounds it on the H100: arithmetic. At the evaluation shape (10M rows
// x 4096 users x 128) one call is 10.5 TFLOP in FP32 FMAs against a 5.12 GB
// table, which the user tiles of one row block (neighbours in launch order)
// read from HBM about once. Tensor cores and TF32 are not used: the counts
// compare f32 scores with targets and seen-row scores computed in f32
// elsewhere, and TF32 would move thousands of near-ties.
//
// Design: the tile of score_groupmax.cu. A block scores a 128-row by
// 128-user tile in 8-deep slices of cc; each of its 256 threads keeps an
// 8 x 8 register tile (8 consecutive rows x 8 users strided by 16). The
// epilogue compares each score with its user's target under the three
// validity bounds, the 16 row-threads of a user column sum their counts in
// shared memory, and one thread per user column adds the block's count to
// counts[u] with one integer atomicAdd (order-independent, so the result is
// deterministic). The thread that holds a user's probe row writes its score
// directly: no one-hot sum as on the TPU. Loads are bounded by c and cc,
// and every offset into the table is 64-bit. Counts are int32: c < 2^31.
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

__device__ __forceinline__ float load_row(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_row(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename RowT>
__global__ void __launch_bounds__(kThreads)
    score_count_kernel(const RowT* __restrict__ rows,
                       const float* __restrict__ reps,
                       const float* __restrict__ targets,
                       const int64_t* __restrict__ probe,
                       int* __restrict__ counts, float* __restrict__ probe_out,
                       int64_t c, int cc, int u, int64_t lo, int64_t col_lo,
                       int64_t n) {
  __shared__ __align__(16) float As[BK][BM + 4];  // rows slice, transposed
  __shared__ float Bs[BK][BN + 4];                // reps slice, transposed
  __shared__ int red[BM / TM][BN];                // per-thread 8-row counts

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

  // This thread's users: targets and clamped probe rows.
  float tgt[TN];
  int64_t prow[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int uu = u0 + tx + j * (BN / TN);
    if (uu < u) {
      tgt[j] = __ldg(targets + uu);
      const int64_t p = __ldg(probe + uu);
      prow[j] = p < 0 ? 0 : (p > c - 1 ? c - 1 : p);
    } else {
      tgt[j] = INFINITY;  // no score is >= +inf: nothing counted
      prow[j] = -1;       // matches no row: nothing written
    }
  }

  int cnt[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) cnt[j] = 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t local = r0 + ty * TM + i;
    const bool valid = local < c && local >= col_lo && lo + local < n;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      cnt[j] += (valid && acc[i][j] >= tgt[j]) ? 1 : 0;
      if (local == prow[j]) probe_out[u0 + tx + j * (BN / TN)] = acc[i][j];
    }
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) red[ty][tx + j * (BN / TN)] = cnt[j];
  __syncthreads();

  if (tid < BN && u0 + tid < u) {
    int sum = 0;
#pragma unroll
    for (int q = 0; q < BM / TM; ++q) sum += red[q][tid];
    if (sum) atomicAdd(counts + u0 + tid, sum);
  }
}

template <typename RowT>
int launch(const RowT* rows, const float* reps, const float* targets,
           const int64_t* probe, int* counts, float* probe_out, long long c,
           int cc, int u, long long lo, long long col_lo, long long n,
           cudaStream_t stream) {
  const long long blocks = (c + BM - 1) / BM * ((u + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (blocks > 0) {
    score_count_kernel<RowT><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
        rows, reps, targets, probe, counts, probe_out, c, cc, u, lo, col_lo, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows [c, cc] (row-major, contiguous), reps [u, cc] f32, targets [u] f32,
// probe [u] int64, counts [u] int32 (zero on entry), probe_out [u] f32.
extern "C" int sbr_score_count_f32(const float* rows, const float* reps,
                                   const float* targets, const int64_t* probe,
                                   int* counts, float* probe_out, long long c,
                                   int cc, int u, long long lo,
                                   long long col_lo, long long n,
                                   cudaStream_t stream) {
  return launch(rows, reps, targets, probe, counts, probe_out, c, cc, u, lo,
                col_lo, n, stream);
}

extern "C" int sbr_score_count_bf16(const __nv_bfloat16* rows,
                                    const float* reps, const float* targets,
                                    const int64_t* probe, int* counts,
                                    float* probe_out, long long c, int cc,
                                    int u, long long lo, long long col_lo,
                                    long long n, cudaStream_t stream) {
  return launch(rows, reps, targets, probe, counts, probe_out, c, cc, u, lo,
                col_lo, n, stream);
}
