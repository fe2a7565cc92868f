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
// x 4096 users x 128) one call is 10.5 TFLOP of products against a 5.12 GB
// table. In FP32 FMAs outside the tensor cores that is 156.5 ms at the
// card's 67 TFLOP/s, a floor no SIMT design passes. The counts compare f32
// scores with targets computed in f32 elsewhere, so a plain TF32 product
// (10 mantissa bits) would move thousands of near-ties. 3xTF32
// (tf32x3.cuh) keeps FP32-grade scores: every product is split into
// a_lo b_hi + a_hi b_lo + a_hi b_hi, whose dropped part is below
// 3 * 2^-22 * sum |a||b| (about 5e-6 on the evaluation's scores, against the
// 2e-5 of the near-tie rule), and runs on the tensor cores at 495 TFLOP/s:
// 3 x 10.5 TFLOP is 63.6 ms, or 2 products (42.4 ms) for bf16 rows, which
// are exact in TF32.
//
// Design: the 3xTF32 score tile of score_tile.cuh (wgmma.m64n128k8 TF32,
// reps pre-split once per call into wgmma's K-major layout, 256 table rows
// a block resident in shared memory for every user tile while cc <= 144 in
// f32 or <= 272 in bf16, bulk copies on full/empty mbarriers), with this
// epilogue per user tile: each score against its user's target under the
// three validity bounds; counts summed over the warp's rows by shuffles and
// over the 16 warps in shared memory (two buffers, so one barrier a tile);
// one integer atomicAdd per user column (order-free, so the result is
// deterministic). The thread that holds a user's clamped probe row writes
// that score.
// * Measured by chip_smoke.py (NVIDIA H100 80GB HBM3, 700.00 W), the scores
//   differ from FP32 cuBLAS's by up to 4.5e-6 at cc = 128 and 1.2e-5 at
//   cc = 512: the tensor cores truncate as they accumulate, well above the
//   split's own bound (tf32x3.cuh).
// Every table offset is 64-bit. Counts are int32: c < 2^31.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "score_tile.cuh"

namespace {

using namespace score_tile;

constexpr int kRedBytes = 2 * sizeof(int) * kWarps * BN;  // two tiles' counts

template <typename RowT, bool kVec, bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
    score_count_kernel(const RowT* __restrict__ rows, const float* __restrict__ tiles,
                       const float* __restrict__ targets,
                       const int64_t* __restrict__ probe,
                       int* __restrict__ counts, float* __restrict__ probe_out,
                       int64_t c, int cc, int u, int64_t lo, int64_t col_lo,
                       int64_t n) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row_w = warp * 16;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * BM;

  // Counts and probes of user tile `tile`, one user column at a time; the
  // warps' counts meet in red[tile % 2], so one barrier a tile suffices.
  auto epilogue = [&](int tile, float (&acc)[64], unsigned char* red) {
    const int u0 = tile * BN;
    int* red_t = reinterpret_cast<int*>(red) + (tile % 2) * kWarps * BN;
    bool valid[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t local = r0 + row_w + g + 8 * h;
      valid[h] = local < c && local >= col_lo && lo + local < n;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = 8 * j + 2 * t + jj;
        float tgt = INFINITY;  // no score is >= +inf: nothing counted
        int64_t prow = -1;     // matches no row: nothing written
        if (u0 + col < u) {
          tgt = __ldg(targets + u0 + col);
          const int64_t p = __ldg(probe + u0 + col);
          prow = p < 0 ? 0 : (p > c - 1 ? c - 1 : p);
        }
        int cnt = 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float s = acc[4 * j + 2 * h + jj];
          cnt += (valid[h] && s >= tgt) ? 1 : 0;
          if (r0 + row_w + g + 8 * h == prow) probe_out[u0 + col] = s;
          acc[4 * j + 2 * h + jj] = 0.0f;
        }
        cnt += __shfl_xor_sync(0xffffffffu, cnt, 4);
        cnt += __shfl_xor_sync(0xffffffffu, cnt, 8);
        cnt += __shfl_xor_sync(0xffffffffu, cnt, 16);
        if (g == 0) red_t[warp * BN + col] = cnt;
      }
    __syncthreads();
    if (tid < BN && u0 + tid < u) {
      int sum = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red_t[w * BN + tid];
      if (sum) atomicAdd(counts + u0 + tid, sum);
    }
  };
  run<RowT, kVec, kResident>(rows, tiles, c, cc, u, r0, smem, kRedBytes, epilogue);
}

template <typename RowT>
int launch(const RowT* rows, const float* reps, float* tiles, const float* targets,
           const int64_t* probe, int* counts, float* probe_out, long long c,
           int cc, int u, long long lo, long long col_lo, long long n,
           cudaStream_t stream) {
  const int split = split_reps(reps, tiles, u, cc, stream);
  if (split != 0) return split;
  const long long blocks = (c + BM - 1) / BM;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  return with_route(rows, cc, kRedBytes, [&](auto vec, auto resident) {
    constexpr bool kVec = decltype(vec)::value;
    constexpr bool kResident = decltype(resident)::value;
    const size_t smem = smem_bytes<RowT>(kResident, (cc + KC - 1) / KC * KC, kRedBytes);
    const cudaError_t err = cudaFuncSetAttribute(
        score_count_kernel<RowT, kVec, kResident>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks > 0) {
      score_count_kernel<RowT, kVec, kResident>
          <<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
              rows, tiles, targets, probe, counts, probe_out, c, cc, u, lo, col_lo, n);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// rows [c, cc] (row-major, contiguous), reps [u, cc] f32, scratch
// (score_tile.cuh scratch_floats(u, cc) floats, which
// sbr_score_submax_scratch_floats(u, cc, 0) returns, 16-byte aligned: the
// TF32 hi and lo of reps, written here), targets [u] f32, probe [u] int64,
// counts [u] int32 (zero on entry), probe_out [u] f32.
extern "C" int sbr_score_count_f32(const float* rows, const float* reps, float* scratch,
                                   const float* targets, const int64_t* probe, int* counts,
                                   float* probe_out, long long c, int cc, int u,
                                   long long lo, long long col_lo, long long n,
                                   cudaStream_t stream) {
  return launch(rows, reps, scratch, targets, probe, counts, probe_out, c, cc, u, lo, col_lo, n,
                stream);
}

extern "C" int sbr_score_count_bf16(const __nv_bfloat16* rows, const float* reps, float* scratch,
                                    const float* targets, const int64_t* probe, int* counts,
                                    float* probe_out, long long c, int cc, int u,
                                    long long lo, long long col_lo, long long n,
                                    cudaStream_t stream) {
  return launch(rows, reps, scratch, targets, probe, counts, probe_out, c, cc, u, lo, col_lo, n,
                stream);
}
