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
// [rows, D] x [D, G*D] product. At the training shapes (B = 256) there are
// two batch rows per SM, so no step has enough work to hide a trip to L2:
// a kernel that re-reads w_h from L2 every step runs at about 1.4 % of its
// FP32 bound. With w_h on chip, the floor of a step is reading w_h from
// shared memory once (D = 128 Coupled: 196,608 B at 128 B/clk, ~1,536 clk);
// at the serving shape (U = 4096, T = 32, D = 127 Normal, 17 GFLOP) it is
// the FP32 FMAs.
//
// Design (the shared parts in lstm_step.cuh; the geometry is chosen in
// ops/lstm_kernels.py recurrence_geometry and passed in):
// * w_h resident in shared memory, FP32, loaded once per call, as the TPU
//   kernel keeps it in VMEM. Where one CTA cannot hold it (D = 127 Normal:
//   258,064 B), a thread-block cluster of C CTAs splits it by hidden unit.
//   Each step CTA q writes its units' new h for the cluster's rows into
//   every CTA's h buffer through distributed shared memory (mapa +
//   st.shared::cluster). h is double-buffered, so one barrier a step (the
//   cluster's, release/acquire; the CTA's when C = 1) orders it; the last
//   step's barrier is also the last before any CTA exits, and no CTA writes
//   into another after it.
// * The carries are reset where they are stored: the thread that computes h
//   and c of step t scales them by keep[t+1] (loaded into registers at the
//   start of the step), so a step reads only h from shared memory.
// * xz[t+1] is copied by cp.async (4 bytes: D may be odd) into the thread's
//   own slots of a double buffer while step t runs. Each thread reads only
//   what it copied, so its wait_group is all the ordering needed.
// * One CTA per SM, the rows per CTA picked for about one wave; each thread
//   owns one unit of RT rows (lstm_step.cuh), so each w_h value read from
//   shared memory feeds RT x G FMAs.
// * Wide route: past what a cluster of 8 can hold (Normal D >~ 330, Coupled
//   D >~ 380) recurrence_geometry picks the L2 kernel below: w_h in global
//   memory (L2-resident), 8 rows a block, the same sum order.
#include <cuda_runtime.h>
#include <math.h>

#include "lstm_step.cuh"

namespace {

using lstm_step::round_up;
using lstm_step::sigmoid_f32;

constexpr int kL2Rows = 8;  // batch rows per block of the wide (L2) route

// The gates of one row and unit from z = xz + acc: the new (c, h). The
// products and the sum of c are rounded one by one (no FMA contraction), as
// the plain version rounds them, so every geometry gives the same bits.
template <int G>
__device__ __forceinline__ void cell_update(const float* z, float& c, float& h) {
  float o;
  if constexpr (G == 3) {
    const float i = sigmoid_f32(z[0]);
    const float g = tanhf(z[1]);
    o = sigmoid_f32(z[2]);
    c = __fadd_rn(__fmul_rn(1.0f - i, c), __fmul_rn(i, g));
  } else {
    const float i = sigmoid_f32(z[0]);
    const float f = sigmoid_f32(z[1]);
    const float g = tanhf(z[2]);
    o = sigmoid_f32(z[3]);
    c = __fadd_rn(__fmul_rn(f, c), __fmul_rn(i, g));
  }
  h = o * tanhf(c);
}

// Shared memory (floats): w_s [round4(D*S)] | h [2][R][Dp4] | xz slots
// [2][G][R][Dcp].
template <int G, int RT>
__global__ void __launch_bounds__(lstm_step::max_threads(RT), 1) lstm_fwd_smem_kernel(
    const float* __restrict__ xz, const float* __restrict__ w_h, const float* __restrict__ keep,
    float* __restrict__ hidden, float* __restrict__ cell, int T, int B, int D, int C, int R) {
  extern __shared__ __align__(16) float smem[];
  const int dc = lstm_step::units_per_cta(D, C);
  const int dcp = round_up(dc, 32);
  const int S = lstm_step::w_stride(G * dc);
  const int dp4 = round_up(D, 4);
  float* w_s = smem;
  float* h_s = w_s + round_up(D * S, 4);
  float* px = h_s + 2 * R * dp4;

  const int j = threadIdx.x % dcp;
  const int r0 = (threadIdx.x / dcp) * RT;  // the thread's first row in the CTA
  const int q = blockIdx.x % C;             // rank in the cluster (1-D clusters along x)
  const int b0 = (blockIdx.x / C) * R;
  const int u = q * dc + j;
  const bool active = j < dc && u < D;
  const size_t gd = static_cast<size_t>(G) * D;

  lstm_step::load_w_slice<G>(w_s, w_h, D, dc, S, q);
  for (int e = threadIdx.x; e < 2 * R * dp4; e += blockDim.x) h_s[e] = 0.0f;
  // xz of the step into slot s: this thread's own G x RT values.
  auto prefetch = [&](int t, int s) {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int b = b0 + r0 + i;
      const bool ok = active && b < B;
      const float* src = ok ? xz + (static_cast<size_t>(t) * B + b) * gd + u : xz;
#pragma unroll
      for (int g = 0; g < G; ++g)
        tf32x3::cp_async4(px + ((s * G + g) * R + r0 + i) * dcp + j, src + (ok ? g * D : 0), ok);
    }
  };
  prefetch(0, 0);
  tf32x3::cp_async_commit();
  tf32x3::cp_async_wait<0>();
  // Every CTA of the cluster has started and zeroed its h before any writes
  // into it; w_s is complete.
  lstm_step::step_sync(C);

  float c[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) c[i] = 0.0f;

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < T;
    tf32x3::cp_async_wait<0>();  // xz[t] (this thread's), copied a step ago
    if (more) prefetch(t + 1, cur ^ 1);
    tf32x3::cp_async_commit();
    float kn[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int b = b0 + r0 + i;
      kn[i] = more && b < B ? __ldg(keep + static_cast<size_t>(t + 1) * B + b) : 0.0f;
    }

    float acc[G][RT];
    lstm_step::gate_product<G, RT>(w_s, S, dc, h_s + (cur * R + r0) * dp4, dp4, D, j, acc);

    if (active) {
      float* h_next = h_s + ((cur ^ 1) * R + r0) * dp4 + u;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        float z[G];
#pragma unroll
        for (int g = 0; g < G; ++g) z[g] = px[((cur * G + g) * R + r0 + i) * dcp + j] + acc[g][i];
        float h;
        cell_update<G>(z, c[i], h);
        const int b = b0 + r0 + i;
        if (b < B) {
          const size_t row = static_cast<size_t>(t) * B + b;
          hidden[row * D + u] = h;
          cell[row * D + u] = c[i];
        }
        if (more) {
          const float hk = h * kn[i];
          c[i] *= kn[i];
          if (C > 1) {
            for (int p = 0; p < C; ++p) lstm_step::st_cluster(lstm_step::cluster_addr(h_next + i * dp4, p), hk);
          } else {
            h_next[i * dp4] = hk;
          }
        }
      }
    }
    lstm_step::step_sync(C);  // h[t] in every CTA's buffer; h[t-1] read by all
  }
}

// The wide route: w_h in global memory (L2-resident), kL2Rows rows a block,
// thread j owns unit j; the carries reset at the start of the step.
template <int G>
__global__ void lstm_fwd_l2_kernel(const float* __restrict__ xz, const float* __restrict__ w_h,
                                   const float* __restrict__ keep, float* __restrict__ hidden,
                                   float* __restrict__ cell, int T, int B, int D) {
  extern __shared__ float h_l2[];  // [kL2Rows][D]: h of the previous step
  const int j = threadIdx.x;
  const bool active = j < D;
  const int b0 = blockIdx.x * kL2Rows;
  const size_t gd = static_cast<size_t>(G) * D;

  float c[kL2Rows];
#pragma unroll
  for (int r = 0; r < kL2Rows; ++r) {
    c[r] = 0.0f;
    if (active) h_l2[r * D + j] = 0.0f;
  }

  for (int t = 0; t < T; ++t) {
    // Thread j touches only column j of h_l2, so no barrier before this.
    if (active) {
#pragma unroll
      for (int r = 0; r < kL2Rows; ++r) {
        const int b = b0 + r;
        const float k = b < B ? keep[static_cast<size_t>(t) * B + b] : 0.0f;
        h_l2[r * D + j] *= k;
        c[r] *= k;
      }
    }
    __syncthreads();

    float acc[G][kL2Rows];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int r = 0; r < kL2Rows; ++r) acc[g][r] = 0.0f;
    if (active) {
#pragma unroll 4
      for (int k = 0; k < D; ++k) {
        float w[G];
#pragma unroll
        for (int g = 0; g < G; ++g) w[g] = __ldg(w_h + static_cast<size_t>(k) * gd + g * D + j);
#pragma unroll
        for (int r = 0; r < kL2Rows; ++r) {
          const float hk = h_l2[r * D + k];
#pragma unroll
          for (int g = 0; g < G; ++g) acc[g][r] = fmaf(hk, w[g], acc[g][r]);
        }
      }
    }
    __syncthreads();  // every thread has read h[t-1] before it is replaced

    if (active) {
#pragma unroll
      for (int r = 0; r < kL2Rows; ++r) {
        const int b = b0 + r;
        if (b >= B) continue;
        const size_t row = static_cast<size_t>(t) * B + b;
        float z[G];
#pragma unroll
        for (int g = 0; g < G; ++g) z[g] = xz[row * gd + g * D + j] + acc[g][r];
        float h;
        cell_update<G>(z, c[r], h);
        h_l2[r * D + j] = h;
        hidden[row * D + j] = h;
        cell[row * D + j] = c[r];
      }
    }
  }
}

template <int G, int RT>
cudaError_t launch_smem(const float* xz, const float* w_h, const float* keep, float* hidden,
                        float* cell, int T, int B, int D, int cluster, int rows, int threads,
                        size_t smem, cudaStream_t stream) {
  const int ctas = cluster * ((B + rows - 1) / rows);
  return lstm_step::launch_clustered(lstm_fwd_smem_kernel<G, RT>, ctas, cluster, threads, smem,
                                     stream, xz, w_h, keep, hidden, cell, T, B, D, cluster, rows);
}

template <int G>
cudaError_t launch_fwd(const float* xz, const float* w_h, const float* keep, float* hidden,
                       float* cell, int T, int B, int D, int cluster, int rows, int threads,
                       size_t smem, int route_smem, cudaStream_t stream) {
  if (!route_smem) {
    if (rows != kL2Rows || cluster != 1 || threads != round_up(D, 32) ||
        smem < sizeof(float) * kL2Rows * D)
      return cudaErrorInvalidValue;
    lstm_fwd_l2_kernel<G><<<(B + kL2Rows - 1) / kL2Rows, threads, smem, stream>>>(
        xz, w_h, keep, hidden, cell, T, B, D);
    return cudaGetLastError();
  }
  // The geometry recurrence_geometry gave: checked against this file's layout.
  const int dc = lstm_step::units_per_cta(D, cluster);
  const int dcp = round_up(dc, 32);
  if (cluster < 1 || cluster > 8 || (cluster - 1) * dc >= D || threads % dcp != 0 ||
      rows % (threads / dcp) != 0)
    return cudaErrorInvalidValue;
  const int rt = rows / (threads / dcp);
  if (threads > lstm_step::max_threads(rt)) return cudaErrorInvalidValue;
  const size_t need = sizeof(float) * (round_up(D * lstm_step::w_stride(G * dc), 4) +
                                       2 * rows * round_up(D, 4) + 2 * G * rows * dcp);
  if (smem < need) return cudaErrorInvalidValue;
  switch (rt) {
    case 1: return launch_smem<G, 1>(xz, w_h, keep, hidden, cell, T, B, D, cluster, rows, threads, smem, stream);
    case 2: return launch_smem<G, 2>(xz, w_h, keep, hidden, cell, T, B, D, cluster, rows, threads, smem, stream);
    case 4: return launch_smem<G, 4>(xz, w_h, keep, hidden, cell, T, B, D, cluster, rows, threads, smem, stream);
    case 8: return launch_smem<G, 8>(xz, w_h, keep, hidden, cell, T, B, D, cluster, rows, threads, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// xz [T, B, G*D], w_h [D, G*D], keep [T, B], hidden/cell [T, B, D]; all f32,
// contiguous, on the current device. G = 3 when coupled, else 4. D <= 1024.
// cluster, rows, threads, smem and route_smem (1: w_h resident, 0: the L2
// route) as ops/lstm_kernels.py recurrence_geometry gives them.
extern "C" int sbr_lstm_fwd_f32(const float* xz, const float* w_h, const float* keep,
                                float* hidden, float* cell, int T, int B, int D, int coupled,
                                int cluster, int rows, int threads, int smem, int route_smem,
                                cudaStream_t stream) {
  if (T > 0 && B > 0 && D > 0) {
    const size_t bytes = static_cast<size_t>(smem);
    const cudaError_t err =
        coupled ? launch_fwd<3>(xz, w_h, keep, hidden, cell, T, B, D, cluster, rows, threads,
                                bytes, route_smem, stream)
                : launch_fwd<4>(xz, w_h, keep, hidden, cell, T, B, D, cluster, rows, threads,
                                bytes, route_smem, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
