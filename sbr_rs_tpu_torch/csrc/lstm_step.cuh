// What the LSTM recurrence kernels (lstm_fwd.cu, K1; lstm_bwd.cu, K2's
// recurrence) share on the H100: the gate product of one step over w_h held
// in shared memory, the geometry of that resident copy, and the cluster
// primitives that hand h (K1) and dh's partial sums (K2) between the CTAs
// of a thread-block cluster when one CTA cannot hold all of w_h.
//
// The resident copy. A cluster of C CTAs splits w_h [D, G*D] by hidden unit:
// CTA q owns units [q*Dc, q*Dc + Dc), Dc = ceil(D / C), and their G gate
// columns. It keeps w_h[k, g*D + q*Dc + j] at w_s[k*S + g*Dc + j] for every
// row k < D, zero where q*Dc + j >= D. The row stride S is the least value
// >= G*Dc that is 1 mod 32, so both products read it without bank
// conflicts: the gate product has lane j read row k at column g*Dc + j
// (consecutive), K2's dh has lane j read row j at column c (one bank apart).
//
// Threads. A CTA has Dcp = Dc rounded up to 32 threads per row group, and
// rows / RT row groups; thread (group, j) owns unit q*Dc + j of the group's
// RT consecutive rows, and walks all T steps.
//
// The sum order. gate_product sums over k = 0 .. D-1 in order with one FMA
// per term from a zero start, whatever C, RT or the route (lstm_fwd.cu's and
// lstm_bwd.cu's L2 kernels keep the same order), so K2's recomputed gates are
// K1's bit for bit. FP32 FMAs, expf / tanhf, no fast-math.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"  // cp.async helpers

namespace lstm_step {

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Units per CTA, threads per row group, and w_s's row stride (1 mod 32).
__host__ __device__ __forceinline__ int units_per_cta(int d, int cluster) {
  return (d + cluster - 1) / cluster;
}
__host__ __device__ __forceinline__ int w_stride(int gdc) {
  return round_up(gdc - 1, 32) + 1;
}

// Threads a CTA may have with RT rows a thread: the kernels' launch bounds
// (255 registers a thread at RT = 8, 128 below it).
__host__ __device__ constexpr int max_threads(int rt) { return rt >= 8 ? 256 : 512; }

// acc[g][i] = sum over k < d of h[i * h_stride + k] * w_s[k * stride + g * dc + j],
// in k order, one fmaf a term. h rows are 16-byte aligned (h_stride a
// multiple of 4); their loads are broadcasts, four k at a time.
template <int G, int RT>
__device__ __forceinline__ void gate_product(const float* __restrict__ w_s, int stride, int dc,
                                             const float* __restrict__ h, int h_stride, int d,
                                             int j, float (&acc)[G][RT]) {
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < RT; ++i) acc[g][i] = 0.0f;
  const float* w = w_s + j;
  int k = 0;
#pragma unroll 2
  for (; k + 4 <= d; k += 4) {
    float hk[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(h + i * h_stride + k);
      hk[i][0] = v.x;
      hk[i][1] = v.y;
      hk[i][2] = v.z;
      hk[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float wk[G];
#pragma unroll
      for (int g = 0; g < G; ++g) wk[g] = w[(k + kk) * stride + g * dc];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g][i] = fmaf(hk[i][kk], wk[g], acc[g][i]);
    }
  }
  for (; k < d; ++k) {
    float wk[G];
#pragma unroll
    for (int g = 0; g < G; ++g) wk[g] = w[k * stride + g * dc];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float hv = h[i * h_stride + k];
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g][i] = fmaf(hv, wk[g], acc[g][i]);
    }
  }
}

// CTA q's slice of w_h [d, G*d] into w_s (zeros past unit d), by 4-byte
// cp.async (rows of odd d are not 16-byte aligned). The caller waits and
// synchronises.
template <int G>
__device__ __forceinline__ void load_w_slice(float* w_s, const float* __restrict__ w_h, int d,
                                             int dc, int stride, int q) {
  const int gdc = G * dc;
  const int gd = G * d;
  for (int e = threadIdx.x; e < d * gdc; e += blockDim.x) {
    const int k = e / gdc;
    const int col = e - k * gdc;
    const int g = col / dc;
    const int u = q * dc + (col - g * dc);
    const bool ok = u < d;
    tf32x3::cp_async4(w_s + k * stride + col, ok ? w_h + static_cast<size_t>(k) * gd + g * d + u : w_h, ok);
  }
}

// Distributed shared memory: the address of `p` (this CTA's shared memory)
// in the CTA of cluster rank `rank`, and a store there.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// Every thread of every CTA of the cluster: stores before it (shared,
// distributed shared, global) are visible to every thread after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// The step's barrier: the CTA's alone when the cluster is one CTA.
__device__ __forceinline__ void step_sync(int cluster) {
  if (cluster > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }
}

// Launch `kernel` on `ctas` CTAs in clusters of `cluster`, with `smem` bytes
// of dynamic shared memory. A cluster the card cannot place is refused with
// an error, never run another way.
template <typename... Params, typename... Args>
cudaError_t launch_clustered(void (*kernel)(Params...), int ctas, int cluster, int threads,
                             size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cluster > 1) {
    int placed = 0;
    err = cudaOccupancyMaxActiveClusters(&placed, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (placed <= 0) return cudaErrorLaunchOutOfResources;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace lstm_step
