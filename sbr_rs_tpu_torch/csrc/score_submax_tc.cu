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
// Design: two score tiles (score_tile.cuh), chosen per call by the caller
// from cc, the row dtype and the card's opt-in shared memory
// (ops/topk_kernels.py submax_tile), K3 and K4 alike. The caller passes
// rows on N's shared memory too (ops/topk_kernels.py rows_on_n_smem_bytes,
// the one count of it: the regions narrow::run lays out); the launch fails
// where the card cannot give a block that much.
//
// * Rows on N (tile 1, RowsOnN), for narrow rows: where
//   its shared memory fits, which on the H100 (232,448 bytes a block)
//   is cc <= 40 in f32 (204,912 bytes at 40; 197,744 at the LSTM-32
//   catalog's 33) and cc <= 64 in bf16 (229,488). Users go on the wgmma's M
//   (A: the reps, split once a call by a pre-pass of their own into one
//   [hi | lo] block per 64-user tile) and table rows on its N (B: 256 rows a
//   block step, fetched by one bulk copy of the next step's raw rows while
//   the tensor cores work, then split into TF32 hi and lo once in shared
//   memory for all user tiles). The depth is round_up(cc, 8): at cc = 33
//   five k-steps. A persistent block (one an SM) walks row blocks; its four
//   warpgroups are two pairs, each pair sharing a ring of two reps tiles
//   (bulk copies on full/empty mbarriers), each warpgroup of a pair taking
//   128 of the 256 rows; the pairs take turns to issue their tiles'
//   wgmmas. A tile's first wgmma writes the accumulators without reading
//   them, so they are dead across the epilogue's temporaries: at 128
//   registers a thread, that keeps the kernel from spilling. A thread's 64
//   accumulators are 2 users x 32 rows
//   (rows 8 j + 2 t, + 1), so the epilogue stays in registers: a maximum
//   over w rows reduces w / 4 values inside the thread and finishes with
//   two shuffles over t, scattered so that lane t stores its own maxima
//   (32-byte runs of 8 users along g). No group spans two warpgroups (w <=
//   128); nothing is staged in shared memory and no barrier joins the
//   warpgroups within a row block, so one warpgroup's epilogue runs under
//   the others' wgmmas. Masking for c and n runs only where a warpgroup's
//   rows cross either bound.
// * Rows on M (tile 0, RowsOnM), any width: K5's tile, run() (256 table
//   rows a block, resident in shared memory for every user tile while they
//   fit, reps pre-split into wgmma's K-major layout, bulk copies on
//   full/empty mbarriers), with this epilogue per user tile: each score is
//   masked to -inf outside the two bounds, then reduced on chip. A warp
//   holds 16 rows x 128 users (rows g and g + 8 at lane g); three shuffles
//   over g give each column's maximum over the warp's 16 rows (sub >= 16),
//   or over each of its two 8-row halves (sub = 8). Those partial maxima
//   meet in shared memory (two buffers, so one barrier a tile), and the
//   block writes 256/w maxima per user for each width, coalesced along the
//   users. No group spans two blocks (w divides 256). Blocks wholly past c
//   only write the -inf rows.
//
// Measured (chip_smoke.py and timing copies, NVIDIA H100 80GB HBM3, 700 W),
// K4 at the LSTM-32 catalog's shape, 50M x 33 f32, sub 32 / group 128:
// rows on M 360.6-366.3 ms at U = 4096 and 19.5-19.7 ms at U = 1; rows on N
// 121.6-124.8 ms and 4.7-5.3 ms. Of rows on M's 360.6 ms, its epilogue took
// 190.6 ms (the block barrier alone 14.1 ms) and the re-split 19.2 ms; of
// rows on N's 124.8 ms the epilogue takes about 9 ms. The tensor cores'
// floor at depth 40 is 99.3 ms (3 products a term at 495 TFLOP/s). At 10M x
// 128 (rows on M) K4 stays at 122.8-123.7 ms.
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
// Both tiles compute the same P products a term (rows_lo reps_hi, rows_hi
// reps_lo, rows_hi reps_hi, the cross products first in each k-step) into
// one FP32 accumulator over the whole depth; they differ only in which
// operand is A and in how the k-steps are grouped. Neither the split's
// term nor the accumulation's depends on the order in which the P * cc
// exact products enter, and the rows-on-N tile's extra k past cc (up to
// round_up(cc, 8)) multiply zeros and add exact zeros. So the bound, and
// phase1_gamma unchanged, hold for both; at width 32 (cc = 33, f32 rows)
// the phase-1 part is 3 * 2^-22 (1 + 2^-10) + 99 * 2^-22 (1 + 2^-8), 2.44e-5
// of S. The bias stays the reps' last column (times the rows' 1.0): the
// epilogue adds nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "score_tile.cuh"

namespace {

using namespace score_tile;

// The two tiles, as the kernel's second template argument.
template <bool kVecRows, bool kResidentRows>
struct RowsOnM {
  static constexpr bool kVec = kVecRows;
  static constexpr bool kResident = kResidentRows;
};
struct RowsOnN {};
constexpr int kTileRowsOnM = 0;
constexpr int kTileRowsOnN = 1;

// Shared memory of the rows-on-M epilogue: two tiles' partial maxima, one
// per `base` rows (8 for sub = 8, else a warp's 16) and user column.
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

template <typename RowT, bool kVec, bool kResident, bool kTwo>
__device__ __forceinline__ void submax_rows_on_m(const RowT* __restrict__ rows, const float* __restrict__ tiles,
                                                 float* __restrict__ smax, float* __restrict__ gmax, int64_t c,
                                                 int cc, int u, int64_t lo, int64_t n, int sub, int group,
                                                 unsigned char* smem) {
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

// The rows-on-N epilogue for maxima of width W: the warpgroup's 128 rows
// from rbase hold 128 / W of them for each of the thread's two users (user,
// user + 8). Each thread first reduces its own columns (W / 4 of each
// maximum's W), then a reduce-scatter over the four lanes t of a row group
// (xor 2, then xor 1) leaves lane t with 128 / W / 4 of the maxima, which
// it stores; for W = 64 and 128 the last steps are all-reductions. Each
// width reduces straight from the accumulators: reducing to per-8-row
// partials first made K4 37 % slower on the H100.
template <int W>
__device__ __forceinline__ void store_maxima(const float (&acc)[64], float* __restrict__ out, int64_t rbase,
                                             int user, int u, int t) {
  constexpr int n = 128 / W;  // maxima of width W in the warpgroup's rows
  constexpr int per = W / 8;  // column groups j of one maximum
  const int64_t orow = rbase / W;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int uu = user + 8 * h;
    const bool on = uu < u;
    float x[n];
#pragma unroll
    for (int i = 0; i < n; ++i) {
      float v = fmaxf(acc[4 * i * per + 2 * h], acc[4 * i * per + 2 * h + 1]);
#pragma unroll
      for (int j = i * per + 1; j < (i + 1) * per; ++j)
        v = fmaxf(v, fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
      x[i] = v;
    }
    if constexpr (n >= 4) {
      float y[n / 2];
#pragma unroll
      for (int i = 0; i < n / 2; ++i) {
        const float keep = (t & 2) ? x[n / 2 + i] : x[i];
        const float give = (t & 2) ? x[i] : x[n / 2 + i];
        y[i] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, give, 2));
      }
#pragma unroll
      for (int i = 0; i < n / 4; ++i) {
        const float keep = (t & 1) ? y[n / 4 + i] : y[i];
        const float give = (t & 1) ? y[i] : y[n / 4 + i];
        const float m = fmaxf(keep, __shfl_xor_sync(0xffffffffu, give, 1));
        if (on) out[(orow + (t >> 1) * (n / 2) + (t & 1) * (n / 4) + i) * u + uu] = m;
      }
    } else if constexpr (n == 2) {
      const float keep = (t & 2) ? x[1] : x[0];
      const float give = (t & 2) ? x[0] : x[1];
      float m = fmaxf(keep, __shfl_xor_sync(0xffffffffu, give, 2));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      if (on && (t & 1) == 0) out[(orow + (t >> 1)) * u + uu] = m;
    } else {
      float m = fmaxf(x[0], __shfl_xor_sync(0xffffffffu, x[0], 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (on && t == 0) out[orow * u + uu] = m;
    }
  }
}

__device__ __forceinline__ void store_maxima(int w, const float (&acc)[64], float* __restrict__ out, int64_t rbase,
                                             int user, int u, int t) {
  switch (w) {
    case 8: store_maxima<8>(acc, out, rbase, user, u, t); break;
    case 16: store_maxima<16>(acc, out, rbase, user, u, t); break;
    case 32: store_maxima<32>(acc, out, rbase, user, u, t); break;
    case 64: store_maxima<64>(acc, out, rbase, user, u, t); break;
    default: store_maxima<128>(acc, out, rbase, user, u, t); break;
  }
}

template <typename RowT, bool kTwo>
__device__ __forceinline__ void submax_rows_on_n(const RowT* __restrict__ rows, const float* __restrict__ tiles,
                                                 float* __restrict__ smax, float* __restrict__ gmax, int64_t c,
                                                 int cc, int u, int64_t lo, int64_t n, int sub, int group,
                                                 unsigned char* smem) {
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int warp_in_wg = tid / 32 % 4;
  // -inf rows past the last row block, up to the 2048-row unit.
  const int64_t scored = (c + narrow::kRows - 1) / narrow::kRows * narrow::kRows;
  const int64_t padded = (c + 2047) / 2048 * 2048;
  for (int pass = kTwo ? 0 : 1; pass < 2; ++pass) {
    const int w = pass ? group : sub;
    float* out = pass ? gmax : smax;
    for (int64_t e = scored / w * u + static_cast<int64_t>(blockIdx.x) * kThreads + tid; e < padded / w * u;
         e += static_cast<int64_t>(gridDim.x) * kThreads)
      out[e] = -INFINITY;
  }
  // Masking only where the warpgroup's rows cross c or the catalog's end.
  auto epilogue = [&](int64_t rbase, int tile, float (&acc)[64]) {
    if (rbase + narrow::kHalf > c || lo + rbase + narrow::kHalf > n) {
#pragma unroll
      for (int j = 0; j < narrow::kHalf / 8; ++j)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int64_t row = rbase + 8 * j + 2 * t + jj;
          if (!(row < c && lo + row < n)) {
            acc[4 * j + jj] = -INFINITY;
            acc[4 * j + 2 + jj] = -INFINITY;
          }
        }
    }
    const int user = tile * narrow::kUsers + 16 * warp_in_wg + g;
    if constexpr (kTwo) store_maxima(sub, acc, smax, rbase, user, u, t);
    store_maxima(group, acc, gmax, rbase, user, u, t);
  };
  narrow::run(rows, tiles, c, cc, u, smem, epilogue);
}

// kTwo: subgroup and group maxima (K4); else group maxima only (K3, called
// with sub = group). Tile: RowsOnM<kVec, kResident> or RowsOnN.
template <typename RowT, typename Tile, bool kTwo>
__global__ void __launch_bounds__(kThreads, 1)
    score_submax_kernel(const RowT* __restrict__ rows, const float* __restrict__ tiles,
                        float* __restrict__ smax, float* __restrict__ gmax, int64_t c, int cc,
                        int u, int64_t lo, int64_t n, int sub, int group) {
  extern __shared__ __align__(128) unsigned char smem[];
  if constexpr (std::is_same<Tile, RowsOnN>::value)
    submax_rows_on_n<RowT, kTwo>(rows, tiles, smax, gmax, c, cc, u, lo, n, sub, group, smem);
  else
    submax_rows_on_m<RowT, Tile::kVec, Tile::kResident, kTwo>(rows, tiles, smax, gmax, c, cc, u, lo, n, sub,
                                                               group, smem);
}

// Floats of the split reps that a tile reads (split_reps's layout for
// rows on M, narrow::split's for rows on N).
long long split_floats(int u, int cc, int tile) {
  return tile == kTileRowsOnN ? narrow::scratch_floats(u, cc) : scratch_floats(u, cc);
}

int split_for(const float* reps, float* scratch, int u, int cc, int tile, cudaStream_t stream) {
  if (tile != kTileRowsOnM && tile != kTileRowsOnN) return static_cast<int>(cudaErrorInvalidValue);
  return tile == kTileRowsOnN ? narrow::split(reps, scratch, u, cc, stream) : split_reps(reps, scratch, u, cc, stream);
}

// tiles: the split reps of `tile` (split_for), 16-byte aligned; smem: rows
// on N's shared memory a block, unread for rows on M. Refuses a tile that
// is neither; cudaFuncSetAttribute refuses smem past the card's opt-in.
template <typename RowT, bool kTwo>
int launch(const RowT* rows, const float* tiles, float* smax, float* gmax, long long c, int cc,
           int u, long long lo, long long n, int sub, int group, int tile, int smem, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(tiles) % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  const long long blocks = (c + 2047) / 2048 * (2048 / BM);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (tile == kTileRowsOnN) {
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const cudaError_t err = cudaFuncSetAttribute(score_submax_kernel<RowT, RowsOnN, kTwo>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long row_blocks = (c + narrow::kRows - 1) / narrow::kRows;
    if (row_blocks > 0) {
      score_submax_kernel<RowT, RowsOnN, kTwo>
          <<<static_cast<unsigned int>(row_blocks < sms ? row_blocks : sms), kThreads, smem, stream>>>(
              rows, tiles, smax, gmax, c, cc, u, lo, n, sub, group);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (tile != kTileRowsOnM) return static_cast<int>(cudaErrorInvalidValue);
  const int red = red_bytes(sub);
  return with_route(rows, cc, red, [&](auto vec, auto resident) {
    using Tile = RowsOnM<decltype(vec)::value, decltype(resident)::value>;
    const size_t bytes = smem_bytes<RowT>(Tile::kResident, (cc + KC - 1) / KC * KC, red);
    const cudaError_t err = cudaFuncSetAttribute(score_submax_kernel<RowT, Tile, kTwo>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks > 0) {
      score_submax_kernel<RowT, Tile, kTwo><<<static_cast<unsigned int>(blocks), kThreads, bytes, stream>>>(
          rows, tiles, smax, gmax, c, cc, u, lo, n, sub, group);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// The opt-in shared memory a block of the current device may use: what
// decides the tile (ops/topk_kernels.py submax_tile).
extern "C" int sbr_smem_per_block_optin() {
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return optin;
}

// Floats of the scratch that `tile`'s calls below split reps [u, cc] into.
extern "C" long long sbr_score_submax_scratch_floats(int u, int cc, int tile) { return split_floats(u, cc, tile); }

// rows [c, cc] (row-major, contiguous), reps [u, cc] f32, scratch
// (sbr_score_submax_scratch_floats(u, cc, tile) floats, 16-byte aligned:
// the TF32 hi and lo of reps, written here), smax [round_up(c, 2048) / sub,
// u] f32, gmax [round_up(c, 2048) / group, u] f32; tile 0 (rows on M) or 1
// (rows on N, with smem bytes of shared memory a block; unread for 0).
extern "C" int sbr_score_submax_tc_f32(const float* rows, const float* reps, float* scratch,
                                       float* smax, float* gmax, long long c, int cc, int u,
                                       long long lo, long long n, int sub, int group, int tile,
                                       int smem, cudaStream_t stream) {
  const int split = split_for(reps, scratch, u, cc, tile, stream);
  return split != 0 ? split
                    : launch<float, true>(rows, scratch, smax, gmax, c, cc, u, lo, n, sub, group, tile, smem,
                                          stream);
}

extern "C" int sbr_score_submax_tc_bf16(const __nv_bfloat16* rows, const float* reps,
                                        float* scratch, float* smax, float* gmax, long long c,
                                        int cc, int u, long long lo, long long n, int sub,
                                        int group, int tile, int smem, cudaStream_t stream) {
  const int split = split_for(reps, scratch, u, cc, tile, stream);
  return split != 0 ? split
                    : launch<__nv_bfloat16, true>(rows, scratch, smax, gmax, c, cc, u, lo, n, sub, group, tile,
                                                  smem, stream);
}

// The TF32 hi and lo of reps [u, cc] into scratch
// (sbr_score_submax_scratch_floats(u, cc, tile) floats, 16-byte aligned),
// which K3's calls below with the same tile read: the running merge splits
// once per batch.
extern "C" int sbr_score_tile_split(const float* reps, float* scratch, int u, int cc, int tile,
                                    cudaStream_t stream) {
  const int status = split_for(reps, scratch, u, cc, tile, stream);
  return status != 0 ? status : static_cast<int>(cudaGetLastError());
}

// K3: gmax [round_up(c, 2048) / group, u] f32 alone, for reps of width cc
// that sbr_score_tile_split wrote into tiles for the same tile; smem as
// above.
extern "C" int sbr_score_groupmax_tc_f32(const float* rows, const float* tiles, float* gmax,
                                         long long c, int cc, int u, long long lo, long long n,
                                         int group, int tile, int smem, cudaStream_t stream) {
  return launch<float, false>(rows, tiles, nullptr, gmax, c, cc, u, lo, n, group, group, tile, smem, stream);
}

extern "C" int sbr_score_groupmax_tc_bf16(const __nv_bfloat16* rows, const float* tiles,
                                          float* gmax, long long c, int cc, int u, long long lo,
                                          long long n, int group, int tile, int smem, cudaStream_t stream) {
  return launch<__nv_bfloat16, false>(rows, tiles, nullptr, gmax, c, cc, u, lo, n, group, group, tile,
                                      smem, stream);
}
