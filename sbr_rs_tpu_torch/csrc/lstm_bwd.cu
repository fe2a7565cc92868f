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
// shapes (B = 256) there are few batch rows to spread over 132 SMs, and each
// step's latency (w_h reads from L2, two barriers) bounds it, not HBM: xz,
// hidden, cell and g are read once, dxz written once. dW_h is a plain
// reduction over T*B rows, 2 * D * G*D * T*B FLOP, small for the card.
//
// Design:
// * The TPU kernel carries dW_h in VMEM scratch across a sequential grid.
//   Blocks here run in no order, so the work splits in two kernels:
//   (a) the recurrence: a block owns R batch rows and walks all T steps
//       itself, writing dxz (an output anyway). R is 2, 4 or 8, chosen from
//       B so that even B = 256 gives 128 blocks;
//   (b) the dW_h reduction, dW_h[k, c] = sum_m A[m, k] * dxz[m + B, c] with
//       A[m] = hidden[m] * keep[m + B] over the m < (T-1)*B rows of t >= 1:
//       64 x 64 output tiles through shared memory, split over row chunks
//       into deterministic per-chunk partials that the wrapper sums.
// * w_h does not fit in shared memory at the training widths (D = 128
//   Normal: 262,144 B; D = 127 Normal: 258,064 B; the limit is 232,448 B),
//   so it stays in global memory, L2-resident, as in the forward. Thread j
//   owns hidden unit j: the recompute reads row k of w_h at column g*D + j,
//   and dh reads w_h^T [G*D, D] (a contiguous transposed copy made by the
//   wrapper) at row c, column j, so both loads coalesce across the warp.
// * Shared memory holds h_prev of the block's rows (broadcast reads in the
//   recompute) and their dz (broadcast reads for dh); two barriers a step.
// * hidden[t-1] and cell[t-1] are read only for t > 0, never index -1.
// * No vector loads: D may be odd (rows of 127 floats are not 16-byte
//   aligned). f32 throughout with expf/tanhf; sums over k in the forward's
//   order, so the recomputed gates match the forward kernel's.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 64;      // dW_h output tile, both dimensions
constexpr int kTileM = 16;     // rows of the reduction per shared-memory stage
constexpr int kDwhThreads = 256;

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <int G, int R>
__global__ void lstm_bwd_recurrence_kernel(
    const float* __restrict__ xz, const float* __restrict__ w_h,
    const float* __restrict__ w_hT, const float* __restrict__ hidden,
    const float* __restrict__ cell, const float* __restrict__ g_in,
    const float* __restrict__ keep, float* __restrict__ dxz, int T, int B,
    int D) {
  extern __shared__ float smem[];
  float* h_s = smem;           // [R][D]: h_prev of the block's rows
  float* dz_s = smem + R * D;  // [R][G*D]: dz of the step
  const int j = threadIdx.x;
  const bool active = j < D;
  const int b0 = blockIdx.x * R;
  const int gd = G * D;

  float dh[R], dc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    dh[r] = 0.0f;
    dc[r] = 0.0f;
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
    __syncthreads();  // h_prev complete; dz_s of the last step fully read

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
        for (int g = 0; g < G; ++g)
          w[g] = __ldg(w_h + static_cast<size_t>(k) * gd + g * D + j);
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
          const float* z = xz + row * gd + j;
          const float tc = tanhf(cell[row * D + j]);
          const float dh_tot = g_in[row * D + j] + dh[r];
          float dc_prev;
          if constexpr (G == 3) {
            const float i = sigmoid_f32(z[0] + acc[0][r]);
            const float gg = tanhf(z[D] + acc[1][r]);
            const float o = sigmoid_f32(z[2 * D] + acc[2][r]);
            const float dc_tot = dc[r] + dh_tot * o * (1.0f - tc * tc);
            dz[0] = dc_tot * (gg - c_prev[r]) * i * (1.0f - i);
            dz[1] = dc_tot * i * (1.0f - gg * gg);
            dz[2] = dh_tot * tc * o * (1.0f - o);
            dc_prev = dc_tot * (1.0f - i);
          } else {
            const float i = sigmoid_f32(z[0] + acc[0][r]);
            const float f = sigmoid_f32(z[D] + acc[1][r]);
            const float gg = tanhf(z[2 * D] + acc[2][r]);
            const float o = sigmoid_f32(z[3 * D] + acc[3][r]);
            const float dc_tot = dc[r] + dh_tot * o * (1.0f - tc * tc);
            dz[0] = dc_tot * gg * i * (1.0f - i);
            dz[1] = dc_tot * c_prev[r] * f * (1.0f - f);
            dz[2] = dc_tot * i * (1.0f - gg * gg);
            dz[3] = dh_tot * tc * o * (1.0f - o);
            dc_prev = dc_tot * f;
          }
          dc[r] = dc_prev * factor[r];
#pragma unroll
          for (int g = 0; g < G; ++g) dxz[row * gd + g * D + j] = dz[g];
        }
#pragma unroll
        for (int g = 0; g < G; ++g) dz_s[r * gd + g * D + j] = dz[g];
      }
    }
    __syncthreads();  // dz of every unit in shared memory

    // dh for step t-1: (dz @ w_h^T)[j] * factor. The next step's first
    // barrier keeps dz_s until every thread is done reading it.
    if (active) {
      float a[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = 0.0f;
#pragma unroll 4
      for (int c = 0; c < gd; ++c) {
        const float w = __ldg(w_hT + static_cast<size_t>(c) * D + j);
#pragma unroll
        for (int r = 0; r < R; ++r) a[r] = fmaf(dz_s[r * gd + c], w, a[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) dh[r] = a[r] * factor[r];
    }
  }
}

// partial[s, k, c] = sum over rows m of chunk s (m < M = (T-1)*B) of
// hidden[m, k] * keep[m + B] * dxz[m + B, c]: row m + B is step t >= 1 and
// row m is its h[t-1]. A 16 x 16 thread block computes one 64 x 64 tile,
// each thread the 4 x 4 outputs (ty + 16 a, tx + 16 b), so the reads of a
// shared row are broadcast (A) or consecutive (B): no bank conflicts.
__global__ void __launch_bounds__(kDwhThreads) lstm_bwd_dwh_kernel(
    const float* __restrict__ hidden, const float* __restrict__ keep,
    const float* __restrict__ dxz, float* __restrict__ partial, int M, int B,
    int D, int GD, int chunk) {
  __shared__ float a_s[kTileM][kTile];  // [m][k]
  __shared__ float b_s[kTileM][kTile];  // [m][c]
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int c0 = blockIdx.x * kTile;
  const int k0 = blockIdx.y * kTile;
  const int m_begin = blockIdx.z * chunk;
  const int m_end = min(M, m_begin + chunk);

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;

  for (int m0 = m_begin; m0 < m_end; m0 += kTileM) {
    for (int e = threadIdx.x; e < kTileM * kTile; e += kDwhThreads) {
      const int mm = e / kTile;
      const int ii = e % kTile;
      const int m = m0 + mm;
      float av = 0.0f, bv = 0.0f;
      if (m < m_end) {
        if (k0 + ii < D)
          av = hidden[static_cast<size_t>(m) * D + k0 + ii] * keep[m + B];
        if (c0 + ii < GD) bv = dxz[static_cast<size_t>(m + B) * GD + c0 + ii];
      }
      a_s[mm][ii] = av;
      b_s[mm][ii] = bv;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < kTileM; ++mm) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = a_s[mm][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = b_s[mm][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }

  float* out = partial + static_cast<size_t>(blockIdx.z) * D * GD;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int k = k0 + ty + 16 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = c0 + tx + 16 * b;
      if (k < D && c < GD) out[static_cast<size_t>(k) * GD + c] = acc[a][b];
    }
  }
}

template <int G, int R>
cudaError_t launch_recurrence(const float* xz, const float* w_h,
                              const float* w_hT, const float* hidden,
                              const float* cell, const float* g,
                              const float* keep, float* dxz, int T, int B,
                              int D, cudaStream_t stream) {
  const int threads = (D + 31) / 32 * 32;
  const dim3 grid((B + R - 1) / R);
  const size_t smem = sizeof(float) * R * D * (1 + G);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lstm_bwd_recurrence_kernel<G, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  lstm_bwd_recurrence_kernel<G, R><<<grid, threads, smem, stream>>>(
      xz, w_h, w_hT, hidden, cell, g, keep, dxz, T, B, D);
  return cudaSuccess;
}

template <int G>
cudaError_t launch_recurrence_rows(const float* xz, const float* w_h,
                                   const float* w_hT, const float* hidden,
                                   const float* cell, const float* g,
                                   const float* keep, float* dxz, int T,
                                   int B, int D, cudaStream_t stream) {
  // Rows per block: as many as keep about two blocks per SM in flight.
  if (B >= 8 * 264)
    return launch_recurrence<G, 8>(xz, w_h, w_hT, hidden, cell, g, keep, dxz,
                                   T, B, D, stream);
  if (B >= 4 * 264)
    return launch_recurrence<G, 4>(xz, w_h, w_hT, hidden, cell, g, keep, dxz,
                                   T, B, D, stream);
  return launch_recurrence<G, 2>(xz, w_h, w_hT, hidden, cell, g, keep, dxz, T,
                                 B, D, stream);
}

}  // namespace

// The recurrence: xz [T, B, G*D], w_h [D, G*D], w_hT [G*D, D], hidden, cell,
// g [T, B, D], keep [T, B] -> dxz [T, B, G*D]; all f32, contiguous, on the
// current device. G = 3 when coupled, else 4. D <= 1024.
extern "C" int sbr_lstm_bwd_f32(const float* xz, const float* w_h,
                                const float* w_hT, const float* hidden,
                                const float* cell, const float* g,
                                const float* keep, float* dxz, int T, int B,
                                int D, int coupled, cudaStream_t stream) {
  if (T > 0 && B > 0 && D > 0) {
    const cudaError_t err =
        coupled ? launch_recurrence_rows<3>(xz, w_h, w_hT, hidden, cell, g,
                                            keep, dxz, T, B, D, stream)
                : launch_recurrence_rows<4>(xz, w_h, w_hT, hidden, cell, g,
                                            keep, dxz, T, B, D, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The dW_h reduction: hidden [T, B, D], keep [T, B], dxz [T, B, GD] ->
// partial [splits, D, GD], chunk rows of the M = (T-1)*B rows per split
// (splits * chunk >= M; a split past M writes zeros).
extern "C" int sbr_lstm_bwd_dwh_f32(const float* hidden, const float* keep,
                                    const float* dxz, float* partial, int T,
                                    int B, int D, int GD, int splits,
                                    int chunk, cudaStream_t stream) {
  if (B > 0 && D > 0 && GD > 0 && splits > 0) {
    const int M = T > 1 ? (T - 1) * B : 0;
    const dim3 grid((GD + kTile - 1) / kTile, (D + kTile - 1) / kTile, splits);
    lstm_bwd_dwh_kernel<<<grid, kDwhThreads, 0, stream>>>(
        hidden, keep, dxz, partial, M, B, D, GD, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
