// LSTM recurrence, forward, for Hopper (sm_90a).
//
// Replaces: sbr_rs_tpu/ops/pallas_lstm.py:_fwd_kernel (launched by
// _fwd_pallas, entry point lstm_apply_pallas). Same contract, time-major:
//   z        = xz[t] + (h[t-1] * keep[t]) @ w_h        (c[t-1] also * keep[t])
//   Normal   [i,f,g,o]: c = sig(f) * c + sig(i) * tanh(g)
//   Coupled  [i,g,o]  : c = (1 - sig(i)) * c + sig(i) * tanh(g)
//   h = sig(o) * tanh(c);  hidden[t] = h, cell[t] = c.
// The input projection x @ w_x + b stays outside (torch.matmul), as on the
// TPU.
//
// What bounds it on the H100: a chain of T dependent steps, each a small
// [rows, D] x [D, G*D] product. At the serving shape (U=4096, T=32, D=127,
// Normal) the recurrence is 17 GFLOP in all, small for the card; the
// per-step latency of reading w_h and the barrier between steps bound it,
// not HBM (xz is read once, hidden and cell written once).
//
// Design:
// * The TPU kernel keeps w_h resident in VMEM. Here w_h does not fit in
//   shared memory at the serving width (127 x 508 x 4 B = 258,064 B, above
//   the 232,448 B a block may use), so it stays in global memory, where it
//   is L2-resident (50 MB) after the first block reads it.
// * Thread j owns hidden unit j: gate columns j, D+j, 2D+j (and 3D+j for
//   Normal). Its loads of w_h rows and xz are coalesced across the warp; no
//   vector loads, because D may be odd (rows of 127 floats are not 16-byte
//   aligned).
// * A block owns kRows batch rows and walks all T steps itself, so nothing
//   carries between blocks. Small tiles give 512 blocks at U=4096 for the
//   132 SMs (the TPU's 512-row tile would give 8).
// * c lives in registers, h of the block's rows in shared memory (read as a
//   broadcast by every thread); two barriers per step.
// * f32 throughout with expf/tanhf (no fast-math intrinsics), so the card
//   agrees with the plain PyTorch loop to about 1e-6.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 8;  // batch rows per block

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <int G>
__global__ void lstm_fwd_kernel(const float* __restrict__ xz,
                                const float* __restrict__ w_h,
                                const float* __restrict__ keep,
                                float* __restrict__ hidden,
                                float* __restrict__ cell, int T, int B, int D) {
  extern __shared__ float h_s[];  // [kRows][D]: h of the previous step
  const int j = threadIdx.x;
  const bool active = j < D;
  const int b0 = blockIdx.x * kRows;
  const size_t gd = static_cast<size_t>(G) * D;

  float c[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    c[r] = 0.0f;
    if (active) h_s[r * D + j] = 0.0f;
  }

  for (int t = 0; t < T; ++t) {
    // Zero the carries where a new window starts (keep == 0). Thread j
    // touches only column j of h_s, so no barrier is needed before this.
    if (active) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int b = b0 + r;
        const float k = b < B ? keep[static_cast<size_t>(t) * B + b] : 0.0f;
        h_s[r * D + j] *= k;
        c[r] *= k;
      }
    }
    __syncthreads();

    float acc[G][kRows];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[g][r] = 0.0f;
    if (active) {
#pragma unroll 4
      for (int k = 0; k < D; ++k) {
        float w[G];
#pragma unroll
        for (int g = 0; g < G; ++g)
          w[g] = __ldg(w_h + static_cast<size_t>(k) * gd + g * D + j);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float hk = h_s[r * D + k];
#pragma unroll
          for (int g = 0; g < G; ++g) acc[g][r] = fmaf(hk, w[g], acc[g][r]);
        }
      }
    }
    __syncthreads();  // every thread has read h[t-1] before it is replaced

    if (active) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int b = b0 + r;
        if (b >= B) continue;
        const size_t row = static_cast<size_t>(t) * B + b;
        const float* z = xz + row * gd + j;
        float c_new, o;
        if constexpr (G == 3) {
          const float i = sigmoid_f32(z[0] + acc[0][r]);
          const float g = tanhf(z[D] + acc[1][r]);
          o = sigmoid_f32(z[2 * D] + acc[2][r]);
          c_new = (1.0f - i) * c[r] + i * g;
        } else {
          const float i = sigmoid_f32(z[0] + acc[0][r]);
          const float f = sigmoid_f32(z[D] + acc[1][r]);
          const float g = tanhf(z[2 * D] + acc[2][r]);
          o = sigmoid_f32(z[3 * D] + acc[3][r]);
          c_new = f * c[r] + i * g;
        }
        const float h_new = o * tanhf(c_new);
        c[r] = c_new;
        h_s[r * D + j] = h_new;
        hidden[row * D + j] = h_new;
        cell[row * D + j] = c_new;
      }
    }
  }
}

}  // namespace

// xz [T, B, G*D], w_h [D, G*D], keep [T, B], hidden/cell [T, B, D]; all f32,
// contiguous, on the current device. G = 3 when coupled, else 4. D <= 1024.
extern "C" int sbr_lstm_fwd_f32(const float* xz, const float* w_h,
                                const float* keep, float* hidden, float* cell,
                                int T, int B, int D, int coupled,
                                cudaStream_t stream) {
  if (T > 0 && B > 0 && D > 0) {
    const int threads = (D + 31) / 32 * 32;
    const dim3 grid((B + kRows - 1) / kRows);
    const size_t smem = sizeof(float) * kRows * D;
    if (coupled) {
      lstm_fwd_kernel<3><<<grid, threads, smem, stream>>>(xz, w_h, keep, hidden,
                                                         cell, T, B, D);
    } else {
      lstm_fwd_kernel<4><<<grid, threads, smem, stream>>>(xz, w_h, keep, hidden,
                                                         cell, T, B, D);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
