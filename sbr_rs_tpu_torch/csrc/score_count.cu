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
// Design: warpgroup MMAs (wgmma.m64n128k8, TF32), the rows as A from
// registers, the reps as B from shared memory.
// * A pre-pass in this source splits reps into TF32 hi and lo once per call
//   (4 MB at u = 4096) and lays them out, zero-padded past u and cc, as one
//   contiguous 16 KB block per (128-user tile, 16-deep k-slice) in wgmma's
//   canonical K-major layout, so the main kernel copies each slice whole.
// * A block owns 256 table rows (four warpgroups of 64) and walks every
//   user tile itself, so the table is read from HBM once and the reps from
//   L2 once per 256 rows. When the block's rows fit shared memory (cc <= 144
//   in f32, <= 272 in bf16) they stay there for all user tiles; then one
//   thread keeps four reps slices in flight with bulk copies
//   (cp.async.bulk) on full/empty mbarriers, and the warpgroups run
//   decoupled, meeting only once per user tile for the counts. Wider rows
//   take a cp.async ring of rows and reps slices with one barrier a slice.
//   Row slices are 16-byte cp.async copies when cc is a multiple of 4 (f32)
//   or 8 (bf16), else plain loads; rows past c and k past cc read as zeros.
// * Per 8-deep k-step a warp reads its A fragment (rows of cc + 4 floats,
//   conflict-free), splits it in registers (bf16 rows are exact: lo = 0) and
//   its warpgroup issues 3 wgmmas (2 for bf16) into 64 FP32 accumulators a
//   thread. wgmma, not mma.sync: on Hopper the warp-level m16n8k8 TF32 MMA
//   issues at a fraction of the warpgroup MMA's rate.
// * Epilogue per user tile: each score against its user's target under
//   the three validity bounds; counts summed over the warp's rows by
//   shuffles and over the 16 warps in shared memory (two buffers, so one
//   barrier a tile); one integer atomicAdd per user column (order-free, so
//   the result is deterministic). The thread that holds a user's clamped
//   probe row writes that score.
// * Measured by chip_smoke.py, the scores differ from FP32 cuBLAS's by up
//   to 4.5e-6 at cc = 128 and 1.2e-5 at cc = 512: the tensor cores
//   truncate as they accumulate, well above the split's own bound
//   (tf32x3.cuh).
// Every table offset is 64-bit. Counts are int32: c < 2^31.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int BM = 256;  // table rows per block: four warpgroups of 64
constexpr int BN = 128;  // users per tile: the wgmma's N
constexpr int KC = 16;   // k per pipeline slot: two wgmma k-steps
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// The reps slices in wgmma's canonical K-major layout without swizzle:
// 16-byte core rows (4 k of one user), 8 users a core matrix, the user
// groups SBO apart and the 4-k chunks LBO apart. The pre-pass writes them
// in this layout, one contiguous [hi | lo] block of kSlotB bytes per
// (user tile, k-slice), in the kernel's walk order.
constexpr int kSbo = 128;               // bytes between groups of 8 users
constexpr int kLbo = BN / 8 * kSbo;     // bytes between 4-k chunks: 2048
constexpr int kHalfB = KC / 4 * kLbo;   // one slice of hi (or lo): 8 KB
constexpr int kSlotB = 2 * kHalfB;      // hi and lo: 16 KB
constexpr int kRedBytes = 2 * sizeof(int) * kWarps * BN;  // two tiles' counts

template <typename RowT>
struct RowTile;
template <>
struct RowTile<float> {
  static constexpr int kPad = 4;       // row stride = width + 4: conflict-free
  static constexpr int kVecElems = 4;  // elements per 16-byte copy
  __device__ static float get(const float* s, int at) { return s[at]; }
  __device__ static float load(const float* p) { return __ldg(p); }
  __device__ static float zero() { return 0.0f; }
};
template <>
struct RowTile<__nv_bfloat16> {
  static constexpr int kPad = 8;
  static constexpr int kVecElems = 8;
  __device__ static float get(const __nv_bfloat16* s, int at) { return __bfloat162float(s[at]); }
  __device__ static __nv_bfloat16 load(const __nv_bfloat16* p) { return *p; }
  __device__ static __nv_bfloat16 zero() { return __float2bfloat16(0.0f); }
};

// Shared memory, resident rows: [BM][ccp + pad] rows (ccp = cc rounded up
// to KC, loaded once), kResidentSlots reps slots, the counts, the slots'
// full and empty mbarriers. Streamed rows: kStreamSlots slots of a
// [BM][KC + pad] rows slice and its reps slice, and the counts.
constexpr int kResidentSlots = 4;
constexpr int kStreamSlots = 2;
template <typename RowT>
__host__ __device__ constexpr size_t a_bytes(int width) {
  return sizeof(RowT) * BM * (width + RowTile<RowT>::kPad);
}
template <typename RowT>
__host__ __device__ constexpr size_t smem_bytes(bool resident, int ccp) {
  return resident ? a_bytes<RowT>(ccp) + kResidentSlots * kSlotB + kRedBytes +
                        2 * kResidentSlots * sizeof(uint64_t)
                  : kStreamSlots * (a_bytes<RowT>(KC) + kSlotB) + kRedBytes;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tf32x3::smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(tf32x3::smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(tf32x3::smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// One reps slot, kSlotB contiguous bytes, by the bulk-copy engine; its
// arrival completes the slot's full barrier.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint64_t* full) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(tf32x3::smem_addr(full)),
               "r"(kSlotB)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(tf32x3::smem_addr(dst)),
      "l"(src), "r"(kSlotB), "r"(tf32x3::smem_addr(full))
      : "memory");
}

// reps [u, cc] -> the TF32 hi and lo of every (user tile, k-slice) in the
// slot layout above, zero past u and cc. Once per call.
__global__ void split_reps_kernel(const float* __restrict__ reps, float* __restrict__ tiles,
                                  int u, int cc, int n_k, int64_t count) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int within = static_cast<int>(i % (KC * BN));  // [k chunk][user][4]
    const int half = static_cast<int>(i / (KC * BN) % 2);
    const int64_t slice = i / (2 * KC * BN);
    const int user = static_cast<int>(slice / n_k) * BN + within / 4 % BN;
    const int k = static_cast<int>(slice % n_k) * KC + within / (4 * BN) * 4 + within % 4;
    const float x = user < u && k < cc ? __ldg(reps + static_cast<int64_t>(user) * cc + k) : 0.0f;
    uint32_t hi, lo;
    tf32x3::split(x, hi, lo);
    tiles[i] = __uint_as_float(half ? lo : hi);
  }
}

template <typename RowT, bool kVec, bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
    score_count_kernel(const RowT* __restrict__ rows, const float* __restrict__ tiles,
                       const float* __restrict__ targets,
                       const int64_t* __restrict__ probe,
                       int* __restrict__ counts, float* __restrict__ probe_out,
                       int64_t c, int cc, int u, int64_t lo, int64_t col_lo,
                       int64_t n) {
  using Tile = RowTile<RowT>;
  constexpr bool kExact = sizeof(RowT) == 2;  // bf16 is exact in TF32: a_lo = 0
  constexpr int kSlots = kResident ? kResidentSlots : kStreamSlots;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row_w = warp * 16;  // this warp's 16 rows; warpgroup warp / 4
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n_k = (cc + KC - 1) / KC;
  const int n_tiles = (u + BN - 1) / BN;
  const int total = n_k * n_tiles;
  const int a_stride = (kResident ? n_k * KC : KC) + Tile::kPad;
  const size_t a_size = kResident ? a_bytes<RowT>(n_k * KC) : a_bytes<RowT>(KC);
  // Slot s: [rows slice, streamed only][reps hi | lo].
  const size_t slot_size = (kResident ? 0 : a_size) + kSlotB;
  unsigned char* ring = smem + (kResident ? a_size : 0);
  int* red = reinterpret_cast<int*>(ring + kSlots * slot_size);  // [2][kWarps][BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 2 * kWarps * BN);
  uint64_t* empty = full + kSlots;
  auto rows_of = [&](int s) {
    return reinterpret_cast<RowT*>(kResident ? smem : ring + s * slot_size);
  };
  auto reps_of = [&](int s) { return ring + s * slot_size + (kResident ? 0 : a_size); };

  // Rows [r0, r0 + BM) x k [k0, k0 + width) into dst (row stride a_stride).
  auto load_rows = [&](RowT* dst, int k0, int width) {
    if constexpr (kVec) {
      constexpr int kv = Tile::kVecElems;
      const int per_row = width / kv;
      for (int e = tid; e < BM * per_row; e += kThreads) {
        const int m = e / per_row;
        const int kk = k0 + (e % per_row) * kv;
        const int64_t row = r0 + m;
        const bool ok = row < c && kk < cc;
        tf32x3::cp_async16(dst + m * a_stride + (kk - k0), ok ? rows + row * cc + kk : rows, ok);
      }
    } else {
      for (int e = tid; e < BM * width; e += kThreads) {
        const int m = e / width;
        const int k = e % width;
        const int64_t row = r0 + m;
        dst[m * a_stride + k] =
            (row < c && k0 + k < cc) ? Tile::load(rows + row * cc + k0 + k) : Tile::zero();
      }
    }
  };
  const float* reps_slice = tiles;  // + it * kSlotB / 4 for step it

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  // acc += rows slice (split in registers) x reps slice (hi, lo).
  auto compute = [&](const RowT* as, const unsigned char* bs) {
    uint32_t ah[KC / 8][4], al[KC / 8][4];
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      const int at = (row_w + g) * a_stride + ks * 8 + t;
      const float x[4] = {Tile::get(as, at), Tile::get(as, at + 8 * a_stride),
                          Tile::get(as, at + 4), Tile::get(as, at + 8 * a_stride + 4)};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (kExact) {
          ah[ks][q] = __float_as_uint(x[q]);
          al[ks][q] = 0u;
        } else {
          tf32x3::split(x[q], ah[ks][q], al[ks][q]);
        }
      }
    }
    tf32x3::wgmma_fence();  // A registers and the accumulators were written
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      const uint64_t d_hi = tf32x3::smem_desc(bs + 2 * ks * kLbo, kLbo, kSbo);
      const uint64_t d_lo = tf32x3::smem_desc(bs + kHalfB + 2 * ks * kLbo, kLbo, kSbo);
      // The cross products first, then hi * hi (tf32x3.cuh).
      if constexpr (!kExact) tf32x3::wgmma_m64n128k8(acc, al[ks], d_hi);
      tf32x3::wgmma_m64n128k8(acc, ah[ks], d_lo);
      tf32x3::wgmma_m64n128k8(acc, ah[ks], d_hi);
    }
    tf32x3::wgmma_commit();
    tf32x3::wgmma_wait_all();
    tf32x3::keep_in_registers(acc);
  };

  // Counts and probes of user tile `tile`, one user column at a time; the
  // warps' counts meet in red[tile % 2], so one barrier a tile suffices.
  auto epilogue = [&](int tile) {
    const int u0 = tile * BN;
    int* red_t = red + (tile % 2) * kWarps * BN;
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

  if constexpr (kResident) {
    // The rows once; then thread 0 keeps kSlots reps slices in flight, each
    // slot released by the four warpgroups through its empty barrier.
    if (tid == 0) {
      for (int s = 0; s < kSlots; ++s) {
        mbar_init(full + s, 1);
        mbar_init(empty + s, kThreads / 128);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    load_rows(rows_of(0), 0, n_k * KC);
    tf32x3::cp_async_commit();
    tf32x3::cp_async_wait<0>();
    __syncthreads();
    if (tid == 0)
      for (int s = 0; s < kSlots && s < total; ++s)
        bulk_load(reps_of(s), reps_slice + static_cast<int64_t>(s) * (kSlotB / 4), full + s);
    for (int it = 0; it < total; ++it) {
      const int s = it % kSlots;
      const int parity = (it / kSlots) & 1;
      mbar_wait(full + s, parity);
      __syncwarp();  // wgmma's .aligned instructions need the warp converged
      compute(rows_of(0) + (it % n_k) * KC, reps_of(s));
      if (tid % 128 == 0) mbar_arrive(empty + s);
      if (tid == 0 && it + kSlots < total) {
        mbar_wait(empty + s, parity);
        bulk_load(reps_of(s), reps_slice + static_cast<int64_t>(it + kSlots) * (kSlotB / 4), full + s);
      }
      __syncwarp();
      if (it % n_k == n_k - 1) epilogue(it / n_k);
    }
  } else {
    // Rows and reps slice by slice through a cp.async ring, one barrier a
    // slice.
    auto load = [&](int s, int it) {
      load_rows(rows_of(s), (it % n_k) * KC, KC);
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(reps_slice) + static_cast<int64_t>(it) * kSlotB;
      for (int e = tid; e < kSlotB / 16; e += kThreads)
        tf32x3::cp_async16(reps_of(s) + 16 * e, src + 16 * e, true);
    };
    for (int s = 0; s < kSlots - 1; ++s) {
      if (s < total) load(s, s);
      tf32x3::cp_async_commit();
    }
    for (int it = 0; it < total; ++it) {
      tf32x3::cp_async_wait<kSlots - 2>();
      // This thread's copies and stores are complete; make them visible to
      // the tensor cores' async proxy, then to the block.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // slice `it` landed; slot (it - 1) % kSlots is free
      if (it + kSlots - 1 < total) load((it + kSlots - 1) % kSlots, it + kSlots - 1);
      tf32x3::cp_async_commit();
      compute(rows_of(it % kSlots), reps_of(it % kSlots));
      if (it % n_k == n_k - 1) epilogue(it / n_k);
    }
  }
}

template <typename RowT, bool kVec, bool kResident>
int launch_kernel(const RowT* rows, const float* tiles, const float* targets,
                  const int64_t* probe, int* counts, float* probe_out, long long c,
                  int cc, int u, long long lo, long long col_lo, long long n,
                  cudaStream_t stream) {
  const long long blocks = (c + BM - 1) / BM;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = smem_bytes<RowT>(kResident, (cc + KC - 1) / KC * KC);
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
}

template <typename RowT, bool kVec>
int launch_vec(const RowT* rows, const float* tiles, const float* targets,
               const int64_t* probe, int* counts, float* probe_out, long long c,
               int cc, int u, long long lo, long long col_lo, long long n,
               cudaStream_t stream) {
  // The rows stay resident for all user tiles when they fit (cc <= 144 in
  // f32, <= 272 in bf16), else they are staged slice by slice.
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  const bool resident = smem_bytes<RowT>(true, (cc + KC - 1) / KC * KC) <= static_cast<size_t>(optin);
  return resident ? launch_kernel<RowT, kVec, true>(rows, tiles, targets, probe, counts,
                                                    probe_out, c, cc, u, lo, col_lo, n, stream)
                  : launch_kernel<RowT, kVec, false>(rows, tiles, targets, probe, counts,
                                                     probe_out, c, cc, u, lo, col_lo, n, stream);
}

long long scratch_floats(int u, int cc) {
  return static_cast<long long>((u + BN - 1) / BN) * ((cc + KC - 1) / KC) * (kSlotB / 4);
}

template <typename RowT>
int launch(const RowT* rows, const float* reps, float* tiles, const float* targets,
           const int64_t* probe, int* counts, float* probe_out, long long c,
           int cc, int u, long long lo, long long col_lo, long long n,
           cudaStream_t stream) {
  const long long count = scratch_floats(u, cc);
  if (count > 0) {
    const long long blocks = (count + 255) / 256;
    split_reps_kernel<<<static_cast<unsigned int>(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
        reps, tiles, u, cc, (cc + KC - 1) / KC, count);
  }
  // 16-byte copies of rows need whole 16-byte pieces of every row and an
  // aligned base; the bulk copies need an aligned scratch.
  if (reinterpret_cast<uintptr_t>(tiles) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const bool vec = cc % RowTile<RowT>::kVecElems == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  return vec ? launch_vec<RowT, true>(rows, tiles, targets, probe, counts, probe_out, c, cc, u, lo,
                                      col_lo, n, stream)
             : launch_vec<RowT, false>(rows, tiles, targets, probe, counts, probe_out, c, cc, u, lo,
                                       col_lo, n, stream);
}

}  // namespace

// Floats of the scratch that sbr_score_count_* take for u users of width cc.
extern "C" long long sbr_score_count_scratch_floats(int u, int cc) { return scratch_floats(u, cc); }

// rows [c, cc] (row-major, contiguous), reps [u, cc] f32, scratch
// (sbr_score_count_scratch_floats(u, cc) floats, 16-byte aligned: the TF32
// hi and lo of reps, written here), targets [u] f32, probe [u] int64,
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
