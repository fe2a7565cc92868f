// Row gather and row read-modify-write over an item table, for Hopper (sm_90a).
//
// Replaces: scripts/row_pipeline_probe.py:pl_gather (P1) and :pl_rmw (P2),
// the Pallas probes of the sparse training step's row traffic. For a table
// [n, c] (f32, or bf16 upcast on load; row-major, contiguous) and int64 ids:
//   gather:  out[i, :] = f32(table[clamp(idx[i], 0, n - 1), :])   out [m, c] f32
//   rmw:     table[idx[i], :] = round(f32(table[idx[i], :]) + f32(delta[i, :]))
//            where 0 <= idx[i] < n; every other id is dropped.
// delta [m, c] is in the table's dtype, so each element is rounded once, to
// the storage dtype, after one f32 add. The in-range ids of one rmw call
// must be unique (the deduplicated rows of the sparse update; the dropped
// sentinel may repeat): each row is read and written by one warp, and no
// atomics are needed.
//
// What bounds it on the H100: bytes. At the sparse step's shape (33,024 rows
// of a 10M x 128 f32 table) a gather moves 33.8 MB and an rmw 50.7 MB: 10 and
// 15 us at 3.35 TB/s, with no arithmetic to speak of. The TPU kernels lost to
// XLA on Mosaic's 8-row blocks and ~40 ns per grid step; here a warp reads a
// whole 512-byte row in one coalesced access.
//
// Design: one warp per row, eight rows per block. Where the row width and the
// pointers allow it, each lane moves 16 bytes per access (a float4 of f32, or
// eight bf16), else one element per lane per step. Offsets into the table
// are 64-bit: 20M x 128 = 2.56e9 elements, past int32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 bytes of a row as floats: kN elements of T.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h[q]);
      v[2 * q] = f.x;
      v[2 * q + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 x;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
    *reinterpret_cast<uint4*>(p) = x;
  }
};

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const T* __restrict__ table, const int64_t* __restrict__ idx,
                       float* __restrict__ out, int64_t n, int64_t m, int c) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= m) return;
  int64_t r = __ldg(idx + i);
  r = r < 0 ? 0 : (r > n - 1 ? n - 1 : r);
  const T* src = table + r * c;
  float* dst = out + i * c;
  if constexpr (kVec) {
    constexpr int V = Vec16<T>::kN;
    for (int j = lane * V; j < c; j += 32 * V) {
      float v[V];
      Vec16<T>::load(src + j, v);
#pragma unroll
      for (int q = 0; q < V; q += 4) Vec16<float>::store(dst + j + q, v + q);
    }
  } else {
    for (int j = lane; j < c; j += 32) dst[j] = to_f32(src[j]);
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    scatter_add_rows_kernel(T* __restrict__ table, const int64_t* __restrict__ idx,
                            const T* __restrict__ delta, int64_t n, int64_t m, int c) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= m) return;
  const int64_t r = __ldg(idx + i);
  if (r < 0 || r >= n) return;  // dropped
  T* row = table + r * c;
  const T* d = delta + i * c;
  if constexpr (kVec) {
    constexpr int V = Vec16<T>::kN;
    for (int j = lane * V; j < c; j += 32 * V) {
      float a[V], b[V];
      Vec16<T>::load(row + j, a);
      Vec16<T>::load(d + j, b);
#pragma unroll
      for (int q = 0; q < V; ++q) a[q] += b[q];
      Vec16<T>::store(row + j, a);
    }
  } else {
    for (int j = lane; j < c; j += 32) store_f32(row + j, to_f32(row[j]) + to_f32(d[j]));
  }
}

int grid_for(long long m, unsigned int* blocks) {
  const long long b = (m + kWarps - 1) / kWarps;
  if (b > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  *blocks = static_cast<unsigned int>(b);
  return 0;
}

template <typename T>
int launch_gather(const T* table, const int64_t* idx, float* out, long long n,
                  long long m, int c, int vec, cudaStream_t stream) {
  unsigned int blocks = 0;
  if (const int err = grid_for(m, &blocks)) return err;
  if (blocks > 0) {
    if (vec) {
      gather_rows_kernel<T, true><<<blocks, kThreads, 0, stream>>>(table, idx, out, n, m, c);
    } else {
      gather_rows_kernel<T, false><<<blocks, kThreads, 0, stream>>>(table, idx, out, n, m, c);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_scatter(T* table, const int64_t* idx, const T* delta, long long n,
                   long long m, int c, int vec, cudaStream_t stream) {
  unsigned int blocks = 0;
  if (const int err = grid_for(m, &blocks)) return err;
  if (blocks > 0) {
    if (vec) {
      scatter_add_rows_kernel<T, true><<<blocks, kThreads, 0, stream>>>(table, idx, delta, n, m, c);
    } else {
      scatter_add_rows_kernel<T, false><<<blocks, kThreads, 0, stream>>>(table, idx, delta, n, m, c);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table [n, c], idx [m] int64, out [m, c] f32. vec != 0: c is a multiple of
// 4 (f32) or 8 (bf16) and table and out are 16-byte aligned.
extern "C" int sbr_gather_rows_f32(const float* table, const int64_t* idx, float* out,
                                   long long n, long long m, int c, int vec,
                                   cudaStream_t stream) {
  return launch_gather(table, idx, out, n, m, c, vec, stream);
}

extern "C" int sbr_gather_rows_bf16(const __nv_bfloat16* table, const int64_t* idx,
                                    float* out, long long n, long long m, int c, int vec,
                                    cudaStream_t stream) {
  return launch_gather(table, idx, out, n, m, c, vec, stream);
}

// table [n, c] (updated in place), idx [m] int64, delta [m, c] in the
// table's dtype. vec != 0: as for the gather, with delta in place of out.
extern "C" int sbr_scatter_add_rows_f32(float* table, const int64_t* idx, const float* delta,
                                        long long n, long long m, int c, int vec,
                                        cudaStream_t stream) {
  return launch_scatter(table, idx, delta, n, m, c, vec, stream);
}

extern "C" int sbr_scatter_add_rows_bf16(__nv_bfloat16* table, const int64_t* idx,
                                         const __nv_bfloat16* delta, long long n, long long m,
                                         int c, int vec, cudaStream_t stream) {
  return launch_scatter(table, idx, delta, n, m, c, vec, stream);
}
