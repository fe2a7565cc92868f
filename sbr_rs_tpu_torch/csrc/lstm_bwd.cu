// LSTM recurrence, backward, for Hopper (sm_90a).
//
// Replaces: sbr_rs_tpu/ops/pallas_lstm.py:_bwd_kernel (launched by
// _bwd_pallas, the VJP of lstm_apply_pallas). Same contract, time-major,
// walking t = T-1 .. 0 with the adjoint carries dh, dc (zero at t = T-1):
//   factor  = keep[t] * (t > 0)
//   h_prev  = h[t-1] * factor,  c_prev = c[t-1] * factor   (0 at t = 0)
//   z       = xz[t] + h_prev @ w_h            (gates recomputed, not stored)
//   dh_tot  = g[t] + dh;  tc = tanh(cell[t])  (the stored cell, as the TPU)
//   dz_o    = dh_tot * tc * o(1-o);  dc_tot = dc + dh_tot * o * (1 - tc^2)
//   Normal  [i,f,g,o]: dz_i = dc_tot g i(1-i), dz_f = dc_tot c_prev f(1-f),
//                      dz_g = dc_tot i (1-g^2), dc' = dc_tot f
//   Coupled [i,g,o]  : dz_i = dc_tot (g - c_prev) i(1-i),
//                      dz_g = dc_tot i (1-g^2), dc' = dc_tot (1-i)
//   dxz[t] = dz;  dh <- (dz @ w_h^T) * factor;  dc <- dc' * factor
//   dW_h   = sum_t h_prev[t]^T dz[t]
// The input projection's gradients (dw_x, db, dx) stay outside: PyTorch's
// autograd of x @ w_x + b, as the TPU version left them to XLA.
//
// What bounds it on the H100: like the forward, a chain of T dependent
// steps, here with two small products per step (the recomputed
// [rows, D] x [D, G*D] and [rows, G*D] x [G*D, D] for dh). At the training
// shapes (B = 256) there are two batch rows per SM, and a step that
// re-reads w_h from L2 twice is latency-bound (1.9 % of the bound). With
// w_h on chip the floor of a step is reading it from shared memory twice
// (D = 128 Coupled: 2 x 196,608 B at 128 B/clk, ~3,072 clk); HBM is not:
// xz, hidden, cell and g are read once, dxz written once. dW_h is a plain
// reduction over T*B rows, 2 * D * G*D * T*B FLOP, small for the card: at
// the ml1m shape (M = 32,512 rows, D = 128, G*D = 384) its 67 MB of
// operands take 0.020 ms at 3.35 TB/s and its 3xTF32 products 0.019 ms at
// 495 TFLOP/s, where FP32 FMAs alone would take 0.048 ms.
//
// Design:
// * The TPU kernel carries dW_h in VMEM scratch across a sequential grid.
//   Blocks here run in no order, so the work splits in two kernels:
//   (a) the recurrence, which writes dxz (an output anyway);
//   (b) the dW_h reduction, dW_h[k, c] = sum_m A[m, k] * dxz[m + B, c] with
//       A[m] = hidden[m] * keep[m + B] over the m < (T-1)*B rows of t >= 1,
//       on the tensor cores in 3xTF32 (tf32x3.cuh) with wgmma.m64n128k8:
//       M = k, N = c, and the reduction K = m runs down the rows of both
//       operands, an MN-major layout that TF32 wgmma does not take. So A
//       (hidden x keep) is gathered into registers from rows staged
//       [m][k] (stride 8 mod 32 floats: conflict-free) and split there, and
//       dxz is transposed while staged: a 4-stage cp.async ring of 32-row
//       stages (16-byte copies when D and G*D are multiples of 4, else
//       4-byte ones) feeds a split + transpose into K-major hi/lo tiles for
//       the next stage while this stage's wgmmas run. 64 x 128 output
//       tiles; the two warpgroups of a block take two k-steps of each stage
//       each and add their sums in a fixed order at the end. Each stage's
//       wgmmas go to a fresh accumulator added to the running one in FP32:
//       the tensor cores truncate as they accumulate, which over a split of
//       thousands of rows drifted to 5e-5 of max|dW_h| (PERF.md).
//       The rows split into about one wave of blocks over the SMs
//       (lstm_kernels.dwh_geometry), each writing its partial tile; a
//       __threadfence and a per-tile ticket follow, and the last block of a
//       tile sums the partials in split order, so the result is the same
//       bits run after run and takes one launch. The last block resets its
//       ticket, so the wrapper's ticket buffer stays zero between calls.
// * The recurrence keeps w_h resident in shared memory, FP32, loaded once
//   per call, in the layout of lstm_step.cuh (row stride 1 mod 32): the
//   recomputed gates read row k at column g*Dc + j, dh reads row j at
//   column c, both without bank conflicts, from the same copy (no
//   transposed copy of w_h). Where one CTA cannot hold w_h (D = 127 Normal),
//   a cluster of C CTAs splits it by unit: each CTA has the dz of its own
//   units' columns, so it forms a partial dh over those columns for every
//   unit and writes each into its owner's slot (distributed shared memory);
//   after the step's cluster barrier the owner adds the C partials in rank
//   order, so the sum is the same bits run after run. The slots alternate
//   by step parity, so one cluster barrier a step orders them; the last
//   step's barrier is the last before any CTA exits.
// * The step's inputs are copied a step ahead by cp.async (4 bytes: D may
//   be odd): each thread its own xz, cell, g of step t-1 and cell of t-2,
//   and its rows' share of hidden[t-2], which it scales by keep[t-1] once
//   it has landed (before the step's last barrier), so the gates read h_prev
//   from shared memory as K1 reads h.
// * The gate product is lstm_step.cuh gate_product, K1's own, so the
//   recomputed gates match the forward kernel's bit for bit. No atomics:
//   two calls give the same bits.
// * Wide route: past what a cluster of 8 holds, recurrence_geometry picks
//   the L2 kernel below (w_h read from global memory, L2-resident); its dh
//   has each warp take whole rows of w_h (coalesced), its lanes' partials
//   added by a butterfly, so it needs no transposed copy either.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lstm_step.cuh"
#include "tf32x3.cuh"

namespace {

using lstm_step::round_up;
using lstm_step::sigmoid_f32;

constexpr int kDwhTileK = 64;    // dW_h rows (hidden units k) per block: wgmma's M
constexpr int kDwhTileC = 128;   // dW_h columns (gate units c) per block: wgmma's N
constexpr int kDwhRows = 32;     // reduction rows m per stage: 4 wgmma k-steps
constexpr int kDwhThreads = 256;  // two warpgroups, two k-steps of each stage each
constexpr int kDwhStages = 4;     // cp.async ring of hidden and dxz rows
constexpr int kDwhAStride = kDwhTileK + 8;  // 72 floats: 8 mod 32, conflict-free
constexpr int kDwhRawStride = kDwhTileC + 4;  // 132 floats: 16-byte rows
constexpr int kDwhRingBytes = 4 * (kDwhRows * kDwhAStride + kDwhRows + kDwhRows * kDwhRawStride);
// dxz rows, transposed while staged into wgmma's K-major layout (K = m):
// core rows of 4 m of one column c, 8 columns SBO apart, 4-m chunks LBO
// apart. LBO is 16 bytes past a multiple of 128, so the 32 lanes' stores of
// one column (m = lane) fall in 32 banks.
constexpr int kDwhSbo = 128;
constexpr int kDwhLbo = kDwhTileC / 8 * kDwhSbo + 16;  // 2064
constexpr int kDwhHalfB = kDwhRows / 4 * kDwhLbo;      // hi (or lo) of a stage
constexpr int kDwhBBytes = 2 * kDwhHalfB;
constexpr int kDwhSmem = kDwhStages * kDwhRingBytes + 2 * kDwhBBytes;
constexpr int kDwhXStride = kDwhTileC + 4;  // the warpgroups' exchange tile

// One row and unit of the adjoint step: z = xz + the recomputed product,
// tc = tanh(cell[t]), dh_tot = g[t] + dh, c_prev = c[t-1] * factor. Writes
// dz and returns dc' (before the factor).
template <int G>
__device__ __forceinline__ float adjoint(const float* z, float tc, float dh_tot, float dc,
                                         float c_prev, float* dz) {
  if constexpr (G == 3) {
    const float i = sigmoid_f32(z[0]);
    const float gg = tanhf(z[1]);
    const float o = sigmoid_f32(z[2]);
    const float dc_tot = dc + dh_tot * o * (1.0f - tc * tc);
    dz[0] = dc_tot * (gg - c_prev) * i * (1.0f - i);
    dz[1] = dc_tot * i * (1.0f - gg * gg);
    dz[2] = dh_tot * tc * o * (1.0f - o);
    return dc_tot * (1.0f - i);
  } else {
    const float i = sigmoid_f32(z[0]);
    const float f = sigmoid_f32(z[1]);
    const float gg = tanhf(z[2]);
    const float o = sigmoid_f32(z[3]);
    const float dc_tot = dc + dh_tot * o * (1.0f - tc * tc);
    dz[0] = dc_tot * gg * i * (1.0f - i);
    dz[1] = dc_tot * c_prev * f * (1.0f - f);
    dz[2] = dc_tot * i * (1.0f - gg * gg);
    dz[3] = dh_tot * tc * o * (1.0f - o);
    return dc_tot * f;
  }
}

// a[i] = sum over c < n of dz[i * dz_stride + c] * w_row[c], in c order, one
// fmaf a term; dz rows 16-byte aligned, read as broadcasts four at a time.
template <int RT>
__device__ __forceinline__ void dz_product(const float* __restrict__ dz, int dz_stride, int n,
                                           const float* __restrict__ w_row, float (&a)[RT]) {
#pragma unroll
  for (int i = 0; i < RT; ++i) a[i] = 0.0f;
  int c = 0;
#pragma unroll 2
  for (; c + 4 <= n; c += 4) {
    float v[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(dz + i * dz_stride + c);
      v[i][0] = x.x;
      v[i][1] = x.y;
      v[i][2] = x.z;
      v[i][3] = x.w;
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float w = w_row[c + cc];
#pragma unroll
      for (int i = 0; i < RT; ++i) a[i] = fmaf(v[i][cc], w, a[i]);
    }
  }
  for (; c < n; ++c) {
    const float w = w_row[c];
#pragma unroll
    for (int i = 0; i < RT; ++i) a[i] = fmaf(dz[i * dz_stride + c], w, a[i]);
  }
}

// Shared memory (floats): w_s [round4(D*S)] | h_prev [2][R][Dp4] | dz
// [R][round4(G*Dc)] | dh partials [2][C][R][Dcp] (C > 1 only) | the
// threads' input slots [2][G+3][R][Dcp] (xz gates, cell[t], g[t], cell[t-1]).
template <int G, int RT>
__global__ void __launch_bounds__(lstm_step::max_threads(RT), 1) lstm_bwd_smem_kernel(
    const float* __restrict__ xz, const float* __restrict__ w_h, const float* __restrict__ hidden,
    const float* __restrict__ cell, const float* __restrict__ g_in, const float* __restrict__ keep,
    float* __restrict__ dxz, int T, int B, int D, int C, int R) {
  constexpr int F = G + 3;
  extern __shared__ __align__(16) float smem[];
  const int dc = lstm_step::units_per_cta(D, C);
  const int dcp = round_up(dc, 32);
  const int gdc = G * dc;
  const int gdc4 = round_up(gdc, 4);
  const int S = lstm_step::w_stride(gdc);
  const int dp4 = round_up(D, 4);
  float* w_s = smem;
  float* hb = w_s + round_up(D * S, 4);
  float* dz_s = hb + 2 * R * dp4;
  float* pdh = dz_s + R * gdc4;
  float* pp = pdh + (C > 1 ? 2 * C * R * dcp : 0);

  const int j = threadIdx.x % dcp;
  const int r0 = (threadIdx.x / dcp) * RT;
  const int q = blockIdx.x % C;
  const int b0 = (blockIdx.x / C) * R;
  const int u = q * dc + j;
  const bool active = j < dc && u < D;
  const size_t gd = static_cast<size_t>(G) * D;
  const int field = R * dcp;  // floats between two fields of a slot

  // Step s's inputs into slot s & 1: this thread's rows of hidden[s-1] at
  // k = j, j + dcp, ..., and its own xz, cell, g of step s and cell[s-1].
  auto prefetch = [&](int s) {
    const int sl = s & 1;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int b = b0 + r0 + i;
      const bool okh = b < B && s > 0;
      const float* hsrc = okh ? hidden + (static_cast<size_t>(s - 1) * B + b) * D : hidden;
      for (int k = j; k < D; k += dcp)
        tf32x3::cp_async4(hb + (sl * R + r0 + i) * dp4 + k, hsrc + (okh ? k : 0), okh);
      const bool ok = active && b < B;
      const size_t row = ok ? static_cast<size_t>(s) * B + b : 0;
      float* slot = pp + sl * F * field + (r0 + i) * dcp + j;
#pragma unroll
      for (int g = 0; g < G; ++g) tf32x3::cp_async4(slot + g * field, xz + row * gd + g * D + (ok ? u : 0), ok);
      tf32x3::cp_async4(slot + G * field, cell + row * D + (ok ? u : 0), ok);
      tf32x3::cp_async4(slot + (G + 1) * field, g_in + row * D + (ok ? u : 0), ok);
      const bool okp = ok && s > 0;
      tf32x3::cp_async4(slot + (G + 2) * field,
                           okp ? cell + (static_cast<size_t>(s - 1) * B + b) * D + u : cell, okp);
    }
  };
  // factor(s) = keep[s] * (s > 0) of this thread's rows.
  auto factors = [&](int s, float (&f)[RT]) {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int b = b0 + r0 + i;
      f[i] = s > 0 && b < B ? __ldg(keep + static_cast<size_t>(s) * B + b) : 0.0f;
    }
  };
  // This thread's copied h_prev values of step s, times factor(s).
  auto scale = [&](int s, const float (&f)[RT]) {
    const int sl = s & 1;
#pragma unroll
    for (int i = 0; i < RT; ++i)
      for (int k = j; k < D; k += dcp) hb[(sl * R + r0 + i) * dp4 + k] *= f[i];
  };

  lstm_step::load_w_slice<G>(w_s, w_h, D, dc, S, q);
  for (int e = threadIdx.x; e < 2 * R * dp4; e += blockDim.x) hb[e] = 0.0f;
  __syncthreads();  // the zeros land before any copy into the same words
  float f[RT], dh[RT], dcar[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    dh[i] = 0.0f;
    dcar[i] = 0.0f;
  }
  prefetch(T - 1);
  tf32x3::cp_async_commit();
  factors(T - 1, f);
  tf32x3::cp_async_wait<0>();
  scale(T - 1, f);
  // w_s and step T-1's h_prev complete; every CTA of the cluster started.
  lstm_step::step_sync(C);

  for (int s = T - 1; s >= 0; --s) {
    const int cur = s & 1;
    float fn[RT];
    if (s > 0) {
      prefetch(s - 1);
      factors(s - 1, fn);
    }
    tf32x3::cp_async_commit();

    float acc[G][RT];
    lstm_step::gate_product<G, RT>(w_s, S, dc, hb + (cur * R + r0) * dp4, dp4, D, j, acc);

#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int b = b0 + r0 + i;
      float dz[G];
#pragma unroll
      for (int g = 0; g < G; ++g) dz[g] = 0.0f;
      if (active && b < B) {
        const float* slot = pp + cur * F * field + (r0 + i) * dcp + j;
        float z[G];
#pragma unroll
        for (int g = 0; g < G; ++g) z[g] = slot[g * field] + acc[g][i];
        const float tc = tanhf(slot[G * field]);
        const float dh_tot = slot[(G + 1) * field] + dh[i];
        const float c_prev = slot[(G + 2) * field] * f[i];
        dcar[i] = adjoint<G>(z, tc, dh_tot, dcar[i], c_prev, dz) * f[i];
        const size_t row = static_cast<size_t>(s) * B + b;
#pragma unroll
        for (int g = 0; g < G; ++g) dxz[row * gd + g * D + u] = dz[g];
      }
      if (j < dc) {
#pragma unroll
        for (int g = 0; g < G; ++g) dz_s[(r0 + i) * gdc4 + g * dc + j] = dz[g];
      }
    }
    __syncthreads();  // the CTA's dz complete

    // dh for step s-1: (dz @ w_h^T) * factor(s), over this CTA's columns.
    if (s > 0) {
      float a[RT];
      if (C == 1) {
        if (active) {
          dz_product<RT>(dz_s + r0 * gdc4, gdc4, gdc, w_s + u * S, a);
#pragma unroll
          for (int i = 0; i < RT; ++i) dh[i] = a[i] * f[i];
        }
      } else if (j < dc) {
        for (int p = 0; p < C; ++p) {
          const int k = p * dc + j;
          if (k >= D) break;
          dz_product<RT>(dz_s + r0 * gdc4, gdc4, gdc, w_s + k * S, a);
          float* mine = pdh + ((cur * C + q) * R + r0) * dcp + j;  // owner p's slot for rank q
#pragma unroll
          for (int i = 0; i < RT; ++i) lstm_step::st_cluster(lstm_step::cluster_addr(mine + i * dcp, p), a[i]);
        }
      }
    }
    tf32x3::cp_async_wait<0>();
    if (s > 0) scale(s - 1, fn);
    // h_prev of step s-1 and the dh partials in place; dz and h_prev of
    // step s read by all.
    lstm_step::step_sync(C);
    if (s > 0) {
      if (C > 1 && active) {
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          float sum = 0.0f;
          for (int p = 0; p < C; ++p) sum += pdh[((cur * C + p) * R + r0 + i) * dcp + j];
          dh[i] = sum * f[i];
        }
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) f[i] = fn[i];
    }
  }
}

// The wide route: w_h in global memory (L2-resident), R rows a block,
// thread j owns unit j. Shared memory: h_prev [R][D], dz [R][G*D], dh [R][D].
template <int G, int R>
__global__ void lstm_bwd_l2_kernel(const float* __restrict__ xz, const float* __restrict__ w_h,
                                   const float* __restrict__ hidden, const float* __restrict__ cell,
                                   const float* __restrict__ g_in, const float* __restrict__ keep,
                                   float* __restrict__ dxz, int T, int B, int D) {
  extern __shared__ float l2_smem[];
  const int gd = G * D;
  float* h_s = l2_smem;
  float* dz_s = h_s + R * D;
  float* dh_s = dz_s + R * gd;
  const int j = threadIdx.x;
  const int lane = j % 32;
  const int warp = j / 32;
  const int warps = blockDim.x / 32;
  const bool active = j < D;
  const int b0 = blockIdx.x * R;

  float dh[R], dcar[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    dh[r] = 0.0f;
    dcar[r] = 0.0f;
  }

  for (int t = T - 1; t >= 0; --t) {
    float factor[R], c_prev[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int b = b0 + r;
      float f = 0.0f, hp = 0.0f, cp = 0.0f;
      if (t > 0 && b < B) {
        f = keep[static_cast<size_t>(t) * B + b];
        if (active) {
          const size_t prev = (static_cast<size_t>(t - 1) * B + b) * D + j;
          hp = hidden[prev] * f;
          cp = cell[prev] * f;
        }
      }
      factor[r] = f;
      c_prev[r] = cp;
      if (active) h_s[r * D + j] = hp;
    }
    __syncthreads();  // h_prev complete; dz_s and dh_s of the last step read

    float acc[G][R];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[g][r] = 0.0f;
    if (active) {
#pragma unroll 4
      for (int k = 0; k < D; ++k) {
        float w[G];
#pragma unroll
        for (int g = 0; g < G; ++g) w[g] = __ldg(w_h + static_cast<size_t>(k) * gd + g * D + j);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float hk = h_s[r * D + k];
#pragma unroll
          for (int g = 0; g < G; ++g) acc[g][r] = fmaf(hk, w[g], acc[g][r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int b = b0 + r;
        float dz[G];
#pragma unroll
        for (int g = 0; g < G; ++g) dz[g] = 0.0f;
        if (b < B) {
          const size_t row = static_cast<size_t>(t) * B + b;
          float z[G];
#pragma unroll
          for (int g = 0; g < G; ++g) z[g] = xz[row * gd + g * D + j] + acc[g][r];
          const float tc = tanhf(cell[row * D + j]);
          const float dh_tot = g_in[row * D + j] + dh[r];
          dcar[r] = adjoint<G>(z, tc, dh_tot, dcar[r], c_prev[r], dz) * factor[r];
#pragma unroll
          for (int g = 0; g < G; ++g) dxz[row * gd + g * D + j] = dz[g];
        }
#pragma unroll
        for (int g = 0; g < G; ++g) dz_s[r * gd + g * D + j] = dz[g];
      }
    }
    __syncthreads();  // dz of every unit in shared memory

    // dh for step t-1: warp w takes units k = w, w + warps, ...; its lanes
    // read row k of w_h (coalesced) over c = lane, lane + 32, ..., and a
    // butterfly adds their sums (every lane ends with the same bits).
    for (int k = warp; k < D; k += warps) {
      float a[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = 0.0f;
      for (int c = lane; c < gd; c += 32) {
        const float w = __ldg(w_h + static_cast<size_t>(k) * gd + c);
#pragma unroll
        for (int r = 0; r < R; ++r) a[r] = fmaf(dz_s[r * gd + c], w, a[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int off = 16; off > 0; off /= 2) a[r] += __shfl_xor_sync(0xffffffffu, a[r], off);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) dh_s[r * D + k] = a[r];
      }
    }
    __syncthreads();  // dh of every unit in shared memory
    if (active) {
#pragma unroll
      for (int r = 0; r < R; ++r) dh[r] = dh_s[r * D + j] * factor[r];
    }
  }
}

// dW_h[k, c] = sum over m < M = (T-1)*B of hidden[m, k] * keep[m + B] *
// dxz[m + B, c]: row m + B is step t >= 1 and row m is its h[t-1]. Block
// (x, y, z) computes the 64 x 128 tile (k0 = 64 y, c0 = 128 x) over the rows
// [z * chunk, min(M, (z + 1) * chunk)). With one split it writes out; else it
// writes partial[z] and the tile's last block to arrive sums the partials in
// split order into out. In wgmma terms M = k, N = c and the reduction K = m:
// A (k x m) is gathered into registers from the staged rows [m][k], keep
// applied, and split; B (m x c) is dxz staged K-major, hi and lo.
template <bool kVec>
__global__ void __launch_bounds__(kDwhThreads, 1) lstm_bwd_dwh_kernel(
    const float* __restrict__ hidden, const float* __restrict__ keep,
    const float* __restrict__ dxz, float* __restrict__ partial,
    unsigned int* __restrict__ tickets, float* __restrict__ out, int M, int B,
    int D, int GD, int splits, int chunk) {
  extern __shared__ __align__(128) unsigned char dwh_smem[];
  __shared__ bool last_block;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wg = warp / 4;   // this warpgroup's k-steps: 2 wg, 2 wg + 1
  const int row = (warp % 4) * 16;  // this warp's 16 rows (k) of the tile
  const int g = lane / 4;
  const int t = lane % 4;
  const int c0 = blockIdx.x * kDwhTileC;
  const int k0 = blockIdx.y * kDwhTileK;
  const int m_begin = blockIdx.z * chunk;
  const int m_end = min(M, m_begin + chunk);
  const int n_st = m_end > m_begin ? (m_end - m_begin + kDwhRows - 1) / kDwhRows : 0;
  // Ring slot s: hidden rows [32][72], their keep [32], dxz rows [32][132].
  auto a_slot = [&](int s) { return reinterpret_cast<float*>(dwh_smem + s * kDwhRingBytes); };
  auto raw_slot = [&](int s) { return a_slot(s) + kDwhRows * kDwhAStride + kDwhRows; };
  auto b_slot = [&](int s) { return dwh_smem + kDwhStages * kDwhRingBytes + s * kDwhBBytes; };

  // Stage st's hidden rows [m0, m0 + 32) x k [k0, k0 + 64), their keep and
  // dxz rows x c [c0, c0 + 128) into ring slot s, by cp.async.
  auto load = [&](int s, int st) {
    float* as = a_slot(s);
    float* ks = as + kDwhRows * kDwhAStride;
    float* raw = raw_slot(s);
    const int m0 = m_begin + st * kDwhRows;
    if constexpr (kVec) {
      for (int e = tid; e < kDwhRows * (kDwhTileK / 4); e += kDwhThreads) {
        const int r = e / (kDwhTileK / 4);
        const int q = (e % (kDwhTileK / 4)) * 4;
        const bool ok = m0 + r < m_end && k0 + q < D;
        tf32x3::cp_async16(as + r * kDwhAStride + q,
                           ok ? hidden + static_cast<size_t>(m0 + r) * D + k0 + q : hidden, ok);
      }
      for (int e = tid; e < kDwhRows * (kDwhTileC / 4); e += kDwhThreads) {
        const int r = e / (kDwhTileC / 4);
        const int q = (e % (kDwhTileC / 4)) * 4;
        const bool ok = m0 + r < m_end && c0 + q < GD;
        tf32x3::cp_async16(raw + r * kDwhRawStride + q,
                           ok ? dxz + static_cast<size_t>(m0 + r + B) * GD + c0 + q : dxz, ok);
      }
    } else {
      for (int e = tid; e < kDwhRows * kDwhTileK; e += kDwhThreads) {
        const int r = e / kDwhTileK;
        const int q = e % kDwhTileK;
        const bool ok = m0 + r < m_end && k0 + q < D;
        tf32x3::cp_async4(as + r * kDwhAStride + q,
                          ok ? hidden + static_cast<size_t>(m0 + r) * D + k0 + q : hidden, ok);
      }
      for (int e = tid; e < kDwhRows * kDwhTileC; e += kDwhThreads) {
        const int r = e / kDwhTileC;
        const int q = e % kDwhTileC;
        const bool ok = m0 + r < m_end && c0 + q < GD;
        tf32x3::cp_async4(raw + r * kDwhRawStride + q,
                          ok ? dxz + static_cast<size_t>(m0 + r + B) * GD + c0 + q : dxz, ok);
      }
    }
    if (tid < kDwhRows) {
      const bool ok = m0 + tid < m_end;
      tf32x3::cp_async4(ks + tid, ok ? keep + m0 + tid + B : keep, ok);
    }
  };

  // The dxz rows of ring slot s, split and transposed into B slot b: thread
  // (m = tid % 32, columns 16 (tid / 32) .. + 15); its 16-byte reads of one
  // row (stride 132 words) and its stores are conflict-free.
  auto transpose_b = [&](int s, int b) {
    const int bm = tid % 32;
    const int bc = (tid / 32) * 16;
    const float4* src = reinterpret_cast<const float4*>(raw_slot(s) + bm * kDwhRawStride + bc);
    unsigned char* bs = b_slot(b) + (bm / 4) * kDwhLbo + (bm % 4) * 4;
#pragma unroll
    for (int q4 = 0; q4 < 4; ++q4) {
      const float4 x = src[q4];
      const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = bc + 4 * q4 + i;
        uint32_t hi, lo;
        tf32x3::split(v[i], hi, lo);
        unsigned char* at = bs + (c / 8) * kDwhSbo + (c % 8) * 16;
        *reinterpret_cast<uint32_t*>(at) = hi;
        *reinterpret_cast<uint32_t*>(at + kDwhHalfB) = lo;
      }
    }
  };

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  for (int s = 0; s < kDwhStages - 1; ++s) {
    if (s < n_st) load(s, s);
    tf32x3::cp_async_commit();
  }
  tf32x3::cp_async_wait<kDwhStages - 2>();
  __syncthreads();
  transpose_b(0, 0);
  for (int st = 0; st < n_st; ++st) {
    // Groups 0 .. st + 1 complete: stage st's hidden rows and stage st + 1's
    // dxz rows are here.
    tf32x3::cp_async_wait<kDwhStages - 3>();
    // This thread's B stores (generic proxy) must be visible to wgmma.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // ring slot (st - 1) % 4 and B slot (st + 1) % 2 are free
    if (st + kDwhStages - 1 < n_st) load((st + kDwhStages - 1) % kDwhStages, st + kDwhStages - 1);
    tf32x3::cp_async_commit();

    const float* as = a_slot(st % kDwhStages);
    const float* ks = as + kDwhRows * kDwhAStride;
    const unsigned char* bs = b_slot(st % 2);
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int mb = (2 * wg + i) * 8;
      const float keep0 = ks[mb + t];
      const float keep1 = ks[mb + t + 4];
      const float x[4] = {
          as[(mb + t) * kDwhAStride + row + g] * keep0,
          as[(mb + t) * kDwhAStride + row + g + 8] * keep0,
          as[(mb + t + 4) * kDwhAStride + row + g] * keep1,
          as[(mb + t + 4) * kDwhAStride + row + g + 8] * keep1,
      };
#pragma unroll
      for (int q = 0; q < 4; ++q) tf32x3::split(x[q], ah[i][q], al[i][q]);
    }
    // The stage's products go to a fresh accumulator (the first MMA
    // overwrites it), added to the running one with FP32 adds: the tensor
    // cores' accumulation truncates, and over a whole split that drifts.
    tf32x3::wgmma_fence();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int mb = (2 * wg + i) * 8;
      const uint64_t d_hi = tf32x3::smem_desc(bs + (mb / 4) * kDwhLbo, kDwhLbo, kDwhSbo);
      const uint64_t d_lo = tf32x3::smem_desc(bs + kDwhHalfB + (mb / 4) * kDwhLbo, kDwhLbo, kDwhSbo);
      tf32x3::wgmma_m64n128k8(part, al[i], d_hi, i > 0);
      tf32x3::wgmma_m64n128k8(part, ah[i], d_lo);
      tf32x3::wgmma_m64n128k8(part, ah[i], d_hi);
    }
    tf32x3::wgmma_commit();
    if (st + 1 < n_st) transpose_b((st + 1) % kDwhStages, (st + 1) % 2);  // under the MMAs
    tf32x3::wgmma_wait_all();
    tf32x3::keep_in_registers(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }

  // Warpgroup 1's sum goes through shared memory to warpgroup 0, which
  // adds it to its own: a fixed order.
  __syncthreads();  // every stage's shared memory is read
  float* xs = reinterpret_cast<float*>(dwh_smem);  // [64][kDwhXStride]
  if (wg == 1) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        xs[(row + g + 8 * (q / 2)) * kDwhXStride + 8 * j + 2 * t + q % 2] = acc[4 * j + q];
  }
  __syncthreads();
  if (wg == 0) {
    float* dst = splits == 1 ? out : partial + static_cast<size_t>(blockIdx.z) * D * GD;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kr = row + g + 8 * (q / 2);
        const int cn = 8 * j + 2 * t + q % 2;
        if (k0 + kr < D && c0 + cn < GD)
          dst[static_cast<size_t>(k0 + kr) * GD + c0 + cn] = acc[4 * j + q] + xs[kr * kDwhXStride + cn];
      }
  }
  if (splits == 1) return;

  // The tile's last block sums every split's partial, in split order.
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) last_block = atomicAdd(tickets + tile, 1u) == static_cast<unsigned int>(splits - 1);
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  // Each thread owns 32 of the tile's elements (a column strip, so the loads
  // coalesce) and keeps all 32 loads of one split in flight.
  constexpr int kPer = kDwhTileK * kDwhTileC / kDwhThreads;
  float sum[kPer];
  unsigned int at[kPer];  // offsets inside one [D, GD] slab: D * GD < 2^31
  bool in[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = k0 + (tid + i * kDwhThreads) / kDwhTileC;
    const int c = c0 + (tid + i * kDwhThreads) % kDwhTileC;
    in[i] = k < D && c < GD;
    at[i] = in[i] ? static_cast<unsigned int>(k * GD + c) : 0u;
    sum[i] = 0.0f;
  }
  const size_t slab = static_cast<size_t>(D) * GD;
#pragma unroll 2
  for (int s = 0; s < splits; ++s) {
    float w[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) w[i] = __ldcg(partial + s * slab + at[i]);
#pragma unroll
    for (int i = 0; i < kPer; ++i) sum[i] += w[i];
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (in[i]) out[at[i]] = sum[i];
  if (tid == 0) tickets[tile] = 0u;  // ready for the next call
}

template <int G, int RT>
cudaError_t launch_smem(const float* xz, const float* w_h, const float* hidden, const float* cell,
                        const float* g, const float* keep, float* dxz, int T, int B, int D,
                        int cluster, int rows, int threads, size_t smem, cudaStream_t stream) {
  const int ctas = cluster * ((B + rows - 1) / rows);
  return lstm_step::launch_clustered(lstm_bwd_smem_kernel<G, RT>, ctas, cluster, threads, smem,
                                     stream, xz, w_h, hidden, cell, g, keep, dxz, T, B, D, cluster,
                                     rows);
}

template <int G, int R>
cudaError_t launch_l2(const float* xz, const float* w_h, const float* hidden, const float* cell,
                      const float* g, const float* keep, float* dxz, int T, int B, int D,
                      int threads, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lstm_bwd_l2_kernel<G, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  lstm_bwd_l2_kernel<G, R><<<(B + R - 1) / R, threads, smem, stream>>>(xz, w_h, hidden, cell, g,
                                                                       keep, dxz, T, B, D);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_recurrence(const float* xz, const float* w_h, const float* hidden,
                              const float* cell, const float* g, const float* keep, float* dxz,
                              int T, int B, int D, int cluster, int rows, int threads, size_t smem,
                              int route_smem, cudaStream_t stream) {
  if (!route_smem) {
    if (cluster != 1 || threads != round_up(D, 32) ||
        smem < sizeof(float) * rows * D * (G + 2))
      return cudaErrorInvalidValue;
    switch (rows) {
      case 2: return launch_l2<G, 2>(xz, w_h, hidden, cell, g, keep, dxz, T, B, D, threads, smem, stream);
      case 4: return launch_l2<G, 4>(xz, w_h, hidden, cell, g, keep, dxz, T, B, D, threads, smem, stream);
      case 8: return launch_l2<G, 8>(xz, w_h, hidden, cell, g, keep, dxz, T, B, D, threads, smem, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  // The geometry recurrence_geometry gave: checked against this file's layout.
  const int dc = lstm_step::units_per_cta(D, cluster);
  const int dcp = round_up(dc, 32);
  if (cluster < 1 || cluster > 8 || (cluster - 1) * dc >= D || threads % dcp != 0 ||
      rows % (threads / dcp) != 0)
    return cudaErrorInvalidValue;
  const int rt = rows / (threads / dcp);
  if (threads > lstm_step::max_threads(rt)) return cudaErrorInvalidValue;
  const size_t need =
      sizeof(float) * (round_up(D * lstm_step::w_stride(G * dc), 4) + 2 * rows * round_up(D, 4) +
                       rows * round_up(G * dc, 4) + (cluster > 1 ? 2 * cluster * rows * dcp : 0) +
                       2 * (G + 3) * rows * dcp);
  if (smem < need) return cudaErrorInvalidValue;
  switch (rt) {
    case 1: return launch_smem<G, 1>(xz, w_h, hidden, cell, g, keep, dxz, T, B, D, cluster, rows, threads, smem, stream);
    case 2: return launch_smem<G, 2>(xz, w_h, hidden, cell, g, keep, dxz, T, B, D, cluster, rows, threads, smem, stream);
    case 4: return launch_smem<G, 4>(xz, w_h, hidden, cell, g, keep, dxz, T, B, D, cluster, rows, threads, smem, stream);
    case 8: return launch_smem<G, 8>(xz, w_h, hidden, cell, g, keep, dxz, T, B, D, cluster, rows, threads, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The recurrence: xz [T, B, G*D], w_h [D, G*D], hidden, cell, g [T, B, D],
// keep [T, B] -> dxz [T, B, G*D]; all f32, contiguous, on the current
// device. G = 3 when coupled, else 4. D <= 1024. cluster, rows, threads,
// smem and route_smem (1: w_h resident, 0: the L2 route) as
// ops/lstm_kernels.py recurrence_geometry(..., backward=True) gives them.
extern "C" int sbr_lstm_bwd_f32(const float* xz, const float* w_h, const float* hidden,
                                const float* cell, const float* g, const float* keep, float* dxz,
                                int T, int B, int D, int coupled, int cluster, int rows,
                                int threads, int smem, int route_smem, cudaStream_t stream) {
  if (T > 0 && B > 0 && D > 0) {
    const size_t bytes = static_cast<size_t>(smem);
    const cudaError_t err =
        coupled ? launch_recurrence<3>(xz, w_h, hidden, cell, g, keep, dxz, T, B, D, cluster,
                                       rows, threads, bytes, route_smem, stream)
                : launch_recurrence<4>(xz, w_h, hidden, cell, g, keep, dxz, T, B, D, cluster,
                                       rows, threads, bytes, route_smem, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The dW_h reduction: hidden [T, B, D], keep [T, B], dxz [T, B, GD] -> out
// [D, GD], chunk rows of the M = (T-1)*B rows per split (a multiple of 32;
// splits * chunk >= M). With splits > 1: partial [splits, D, GD] scratch and
// tickets [ceil(D/64) * ceil(GD/128)] zeros, left zero again on return.
// All f32 (tickets uint32), contiguous, on the current device.
extern "C" int sbr_lstm_bwd_dwh_f32(const float* hidden, const float* keep,
                                    const float* dxz, float* partial,
                                    unsigned int* tickets, float* out, int T,
                                    int B, int D, int GD, int splits,
                                    int chunk, cudaStream_t stream) {
  if (B > 0 && D > 0 && GD > 0 && splits > 0) {
    const int M = T > 1 ? (T - 1) * B : 0;
    const dim3 grid((GD + kDwhTileC - 1) / kDwhTileC, (D + kDwhTileK - 1) / kDwhTileK, splits);
    const size_t smem = kDwhSmem;
    const bool vec = D % 4 == 0 && GD % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(hidden) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(dxz) % 16 == 0;
    const auto kernel = vec ? lstm_bwd_dwh_kernel<true> : lstm_bwd_dwh_kernel<false>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kDwhThreads, smem, stream>>>(hidden, keep, dxz, partial, tickets, out, M, B,
                                                D, GD, splits, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
