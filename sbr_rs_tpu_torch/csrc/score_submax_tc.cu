// Catalog scoring fused with subgroup and group maxima, or group maxima
// alone, on Hopper's tensor cores in 3xTF32 (sm_90a).
//
// Replaces: sbr_rs_tpu/ops/pallas_topk.py:_submax_groupmax_kernel
// (score_submax_groupmax, K4) and :_groupmax_kernel (score_groupmax, K3,
// the one-output mode below), phase 1 of the exact two-phase top-k of
// serving. For table rows [c, cc] (f32, or bf16, exact in TF32) and
// bias-augmented user representations reps [u, cc] (f32):
//   s[i, u]     = sum_k rows[i, k] * reps[u, k], in 3xTF32
//   s[i, u]     = -inf unless (lo + i < n) and (i < c)
//   smax[g, u]  = max of s over rows [g*sub, (g+1)*sub)
//   gmax[g, u]  = max of s over rows [g*group, (g+1)*group)
// Both outputs carry round_up(c, 2048) / width rows, the rows past c all
// -inf (the row contract of the TPU functions, groupmax_rows). sub and group
// are in {8, 16, 32, 64, 128}, sub < group, group % sub == 0. Every offset
// is 64-bit (the 10M-row subgroup stack has 1.28e9 elements). K3 is the
// same kernel with kTwo = false: gmax only (the launcher passes sub =
// group), for one catalog chunk of the running merge at a time, and its
// arithmetic is K4's, so the error bound below is K3's too.
//
// What bounds it on the H100: arithmetic. At the serving shape (10M rows x
// 4096 users x 128) one call is 10.5 TFLOP of products against a 5.12 GB
// table. On the H100 SXM's published peaks that is 156.5 ms in FP32 FMAs at
// 67 TFLOP/s, the floor of the SIMT kernel (score_groupmax.cu), and 63.6 ms
// as 3 TF32 products a term at 495 TFLOP/s (42.4 ms for bf16 rows: 2
// products). The two stacks of maxima are 5.12 GB and 1.28 GB at sub 32 /
// group 128, 1.9 ms of writes at 3.35 TB/s.
//
// Design: the score tile of score_tile.cuh, K5's (256 table rows a block,
// resident in shared memory for every user tile while they fit, reps
// pre-split into wgmma's K-major layout, bulk copies on full/empty
// mbarriers), with this epilogue per user tile: each score is masked to
// -inf outside the two bounds, then reduced on chip. A warp holds 16 rows x
// 128 users (rows g and g + 8 at lane g); three shuffles over g give each
// column's maximum over the warp's 16 rows (sub >= 16), or over each of its
// two 8-row halves (sub = 8). Those partial maxima meet in shared memory
// (two buffers, so one barrier a tile), and the block writes 256/w maxima
// per user for each width, coalesced along the users. No group spans two
// blocks (w divides 256). Blocks wholly past c only write the -inf rows.
//
// The error bound. Against the exact dot, a score is off by at most
//   the split's dropped part: 3 * 2^-22 (1 + 2^-10) * S (f32 rows),
//                                2^-22 (1 + 2^-10) * S (bf16 rows)
//   plus the accumulation:   P * cc * 2^-22 * (1 + 2^-8) * S
// with S = sum_k |rows[i, k]| |reps[u, k]| and P = 3 products a term (2 for
// bf16). The products of TF32 values are exact in FP32, but the tensor
// cores truncate as they add: each product enters the accumulator through
// at most two truncations (its alignment to the larger operand, and the
// normalisation of the sum it joins), each of at most one unit in the last
// place of FP32 (2^-23) of a running magnitude that stays below
// (1 + 2^-8) S. ops/topk_kernels.py phase1_gamma adds phase 2's own FP32
// dot, and phase1_error_bound bounds S by sum_k |reps[u, k]| max_i
// |rows[i, k]|; the serving path certifies its top-k with it
// (models/base.py topk_streamed). chip_smoke.py measures the error on
// all-positive inputs, where no cancellation hides it, beside this bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "score_tile.cuh"

namespace {

using namespace score_tile;

// Shared memory of the epilogue: two tiles' partial maxima, one per
// `base` rows (8 for sub = 8, else a warp's 16) and user column.
__host__ __device__ int red_bytes(int sub) {
  return 2 * static_cast<int>(sizeof(float)) * (BM / (sub < 16 ? sub : 16)) * BN;
}

// Maxima of width w over the block's rows from the partial maxima in red
// ([BM / base][BN], one per `base` rows), written to out rows
// [r0 / w, r0 / w + BM / w).
__device__ __forceinline__ void write_maxima(const float* red, float* __restrict__ out, int w,
                                             int base, int64_t r0, int u0, int u) {
  const int per = w / base;
  const int outs = BM / w;
  const int64_t orow0 = r0 / w;
  for (int e = threadIdx.x; e < outs * BN; e += kThreads) {
    const int s = e / BN;
    const int col = e % BN;
    const int uu = u0 + col;
    if (uu >= u) continue;
    float v = red[(s * per) * BN + col];
    for (int q = 1; q < per; ++q) v = fmaxf(v, red[(s * per + q) * BN + col]);
    out[(orow0 + s) * static_cast<int64_t>(u) + uu] = v;
  }
}

__device__ __forceinline__ float warp_max_over_g(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
}

// kTwo: subgroup and group maxima (K4); else group maxima only (K3, called
// with sub = group).
template <typename RowT, bool kVec, bool kResident, bool kTwo>
__global__ void __launch_bounds__(kThreads, 1)
    score_submax_kernel(const RowT* __restrict__ rows, const float* __restrict__ tiles,
                        float* __restrict__ smax, float* __restrict__ gmax, int64_t c, int cc,
                        int u, int64_t lo, int64_t n, int sub, int group) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row_w = warp * 16;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int base = sub < 16 ? sub : 16;

  if (r0 >= c) {  // padding up to the 2048-row unit: -inf rows only
    for (int pass = kTwo ? 0 : 1; pass < 2; ++pass) {
      const int w = pass ? group : sub;
      float* out = pass ? gmax : smax;
      const int64_t count = static_cast<int64_t>(BM / w) * u;
      for (int64_t e = tid; e < count; e += kThreads) out[(r0 / w) * u + e] = -INFINITY;
    }
    return;
  }

  auto epilogue = [&](int tile, float (&acc)[64], unsigned char* red_mem) {
    const int u0 = tile * BN;
    float* red = reinterpret_cast<float*>(red_mem) + (tile % 2) * (BM / base) * BN;
    bool valid[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t local = r0 + row_w + g + 8 * h;
      valid[h] = local < c && lo + local < n;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = 8 * j + 2 * t + jj;
        const float v0 = valid[0] ? acc[4 * j + jj] : -INFINITY;
        const float v1 = valid[1] ? acc[4 * j + 2 + jj] : -INFINITY;
        acc[4 * j + jj] = 0.0f;
        acc[4 * j + 2 + jj] = 0.0f;
        if (base == 16) {
          const float v = warp_max_over_g(fmaxf(v0, v1));
          if (g == 0) red[warp * BN + col] = v;
        } else {
          const float m0 = warp_max_over_g(v0);
          const float m1 = warp_max_over_g(v1);
          if (g == 0) {
            red[(2 * warp) * BN + col] = m0;
            red[(2 * warp + 1) * BN + col] = m1;
          }
        }
      }
    __syncthreads();
    if constexpr (kTwo) write_maxima(red, smax, sub, base, r0, u0, u);
    write_maxima(red, gmax, group, base, r0, u0, u);
  };
  run<RowT, kVec, kResident>(rows, tiles, c, cc, u, r0, smem, red_bytes(sub), epilogue);
}

// tiles: the split reps (split_reps), 16-byte aligned.
template <typename RowT, bool kTwo>
int launch(const RowT* rows, const float* tiles, float* smax, float* gmax, long long c, int cc,
           int u, long long lo, long long n, int sub, int group, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(tiles) % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  const long long blocks = (c + 2047) / 2048 * (2048 / BM);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int red = red_bytes(sub);
  return with_route(rows, cc, red, [&](auto vec, auto resident) {
    constexpr bool kVec = decltype(vec)::value;
    constexpr bool kResident = decltype(resident)::value;
    const size_t smem = smem_bytes<RowT>(kResident, (cc + KC - 1) / KC * KC, red);
    const cudaError_t err = cudaFuncSetAttribute(
        score_submax_kernel<RowT, kVec, kResident, kTwo>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks > 0) {
      score_submax_kernel<RowT, kVec, kResident, kTwo>
          <<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
              rows, tiles, smax, gmax, c, cc, u, lo, n, sub, group);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// rows [c, cc] (row-major, contiguous), reps [u, cc] f32, scratch
// (sbr_score_tile_scratch_floats(u, cc) floats, 16-byte aligned: the
// TF32 hi and lo of reps, written here), smax [round_up(c, 2048) / sub, u]
// f32, gmax [round_up(c, 2048) / group, u] f32.
extern "C" int sbr_score_submax_tc_f32(const float* rows, const float* reps, float* scratch,
                                       float* smax, float* gmax, long long c, int cc, int u,
                                       long long lo, long long n, int sub, int group,
                                       cudaStream_t stream) {
  const int split = split_reps(reps, scratch, u, cc, stream);
  return split != 0 ? split : launch<float, true>(rows, scratch, smax, gmax, c, cc, u, lo, n, sub, group, stream);
}

extern "C" int sbr_score_submax_tc_bf16(const __nv_bfloat16* rows, const float* reps,
                                        float* scratch, float* smax, float* gmax, long long c,
                                        int cc, int u, long long lo, long long n, int sub,
                                        int group, cudaStream_t stream) {
  const int split = split_reps(reps, scratch, u, cc, stream);
  return split != 0 ? split
                    : launch<__nv_bfloat16, true>(rows, scratch, smax, gmax, c, cc, u, lo, n, sub, group, stream);
}

// The TF32 hi and lo of reps [u, cc] into scratch
// (sbr_score_tile_scratch_floats(u, cc) floats, 16-byte aligned), which
// K3's calls below read: the running merge splits once per batch.
extern "C" int sbr_score_tile_split(const float* reps, float* scratch, int u, int cc,
                                    cudaStream_t stream) {
  const int status = split_reps(reps, scratch, u, cc, stream);
  return status != 0 ? status : static_cast<int>(cudaGetLastError());
}

// K3: gmax [round_up(c, 2048) / group, u] f32 alone, for reps of width cc
// that sbr_score_tile_split wrote into tiles.
extern "C" int sbr_score_groupmax_tc_f32(const float* rows, const float* tiles, float* gmax,
                                         long long c, int cc, int u, long long lo, long long n,
                                         int group, cudaStream_t stream) {
  return launch<float, false>(rows, tiles, nullptr, gmax, c, cc, u, lo, n, group, group, stream);
}

extern "C" int sbr_score_groupmax_tc_bf16(const __nv_bfloat16* rows, const float* tiles,
                                          float* gmax, long long c, int cc, int u, long long lo,
                                          long long n, int group, cudaStream_t stream) {
  return launch<__nv_bfloat16, false>(rows, tiles, nullptr, gmax, c, cc, u, lo, n, group, group,
                                      stream);
}
