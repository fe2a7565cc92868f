// The 3xTF32 catalog-scoring tiles: table rows [c, cc] (f32, or bf16 exact
// in TF32) against bias-augmented user representations reps [u, cc] (f32),
// on Hopper's tensor cores (wgmma.m64n128k8 TF32 with the split of
// tf32x3.cuh). Two tiles:
//
// * Rows on M, run() below, any width: shared by score_count.cu (K5, the
//   rank count) and score_submax_tc.cu (K4 and K3, the subgroup and group
//   maxima), which differ only in what their epilogue does with each [256
//   rows x 128 users] score tile. A thread holds 2 rows x 64 users, so a
//   reduction over rows crosses lanes and warps (shared memory and a block
//   barrier a tile), and the rows are split again for every user tile.
// * Rows on N, narrow::run() at the end, for K4 and K3 on narrow rows
//   (where its shared memory fits the card: cc <= 40 in f32, <= 64 in
//   bf16 on the H100): users on the wgmma's M, rows on its N, so a thread
//   holds 2 users x 32 rows and reduces rows in registers; the rows are
//   split once a block. Its notes are there and in score_submax_tc.cu. K5
//   keeps rows on M: its counts meet across rows in any case.
//
// The rows-on-M tile:
//
// * split_reps_kernel, once per call, splits reps into TF32 hi and lo and
//   lays them out, zero-padded past u and cc, as one contiguous 16 KB block
//   per (128-user tile, 16-deep k-slice) in wgmma's canonical K-major
//   layout, so the main kernel copies each slice whole.
// * run(): a block owns BM = 256 table rows (four warpgroups of 64) and
//   walks every user tile itself, so the table is read from HBM once and
//   the reps from L2 once per 256 rows. When the block's rows fit shared
//   memory (cc <= 144 in f32, <= 272 in bf16) they stay there for all user
//   tiles; one thread keeps four reps slices in flight with bulk copies
//   (cp.async.bulk) on full/empty mbarriers, and the warpgroups run
//   decoupled, meeting only in the epilogue. Wider rows take a cp.async ring
//   of rows and reps slices with one barrier a slice. Row slices are 16-byte
//   cp.async copies when cc is a multiple of 4 (f32) or 8 (bf16), else plain
//   loads; rows past c and k past cc read as zeros.
// * Per 8-deep k-step a warp reads its A fragment (rows of cc + 4 floats,
//   conflict-free), splits it in registers (bf16 rows are exact: lo = 0) and
//   its warpgroup issues 3 wgmmas (2 for bf16) into 64 FP32 accumulators a
//   thread: rows 16 w + g and 16 w + g + 8 of the block for warp w, lane
//   (g = lane / 4, t = lane % 4), columns 8 j + 2 t (+ 1) of the user tile
//   (tf32x3.cuh). One accumulator runs over the whole cc-deep sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"

// Everything here is inline, a template or static (split_reps_kernel), so
// that each source that includes it keeps its own copy.
namespace score_tile {

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
// to KC, loaded once), kResidentSlots reps slots, the epilogue's red_bytes,
// the slots' full and empty mbarriers. Streamed rows: kStreamSlots slots of
// a [BM][KC + pad] rows slice and its reps slice, and the epilogue's bytes.
constexpr int kResidentSlots = 4;
constexpr int kStreamSlots = 2;
template <typename RowT>
__host__ __device__ constexpr size_t a_bytes(int width) {
  return sizeof(RowT) * BM * (width + RowTile<RowT>::kPad);
}
template <typename RowT>
__host__ __device__ constexpr size_t smem_bytes(bool resident, int ccp, int red_bytes) {
  return resident ? a_bytes<RowT>(ccp) + kResidentSlots * kSlotB + red_bytes +
                        2 * kResidentSlots * sizeof(uint64_t)
                  : kStreamSlots * (a_bytes<RowT>(KC) + kSlotB) + red_bytes;
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
// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// by the bulk-copy engine; their arrival completes `bar`'s phase, which
// this call arrives on.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(tf32x3::smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(tf32x3::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(tf32x3::smem_addr(bar))
      : "memory");
}
// One reps slot, kSlotB contiguous bytes; its arrival completes the slot's
// full barrier.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint64_t* full) {
  bulk_copy(dst, src, kSlotB, full);
}

// reps [u, cc] -> the TF32 hi and lo of every (tile of bn users, k-slice
// of kc) in the slot layout above (bn = BN, kc = KC: run()'s; the
// rows-on-N tile below takes bn = 64 and one slice of the whole depth),
// zero past u and cc.
static __global__ void split_reps_kernel(const float* __restrict__ reps, float* __restrict__ tiles,
                                         int u, int cc, int kc, int bn, int n_k, int64_t count) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int within = static_cast<int>(i % (kc * bn));  // [k chunk][user][4]
    const int half = static_cast<int>(i / (kc * bn) % 2);
    const int64_t slice = i / (2 * kc * bn);
    const int user = static_cast<int>(slice / n_k) * bn + within / 4 % bn;
    const int k = static_cast<int>(slice % n_k) * kc + within / (4 * bn) * 4 + within % 4;
    const float x = user < u && k < cc ? __ldg(reps + static_cast<int64_t>(user) * cc + k) : 0.0f;
    uint32_t hi, lo;
    tf32x3::split(x, hi, lo);
    tiles[i] = __uint_as_float(half ? lo : hi);
  }
}

// Floats of the split reps for u users of width cc, in tiles of bn users
// and slices of kc.
inline long long scratch_floats(int u, int cc, int kc = KC, int bn = BN) {
  return static_cast<long long>((u + bn - 1) / bn) * ((cc + kc - 1) / kc) * 2 * kc * bn;
}

// Launches split_reps_kernel into tiles (scratch_floats(u, cc, kc, bn)
// floats); returns cudaErrorMisalignedAddress when tiles is not 16-byte
// aligned (the bulk copies need it), else cudaSuccess.
inline int split_reps(const float* reps, float* tiles, int u, int cc, cudaStream_t stream, int kc = KC,
                      int bn = BN) {
  const long long count = scratch_floats(u, cc, kc, bn);
  if (count > 0) {
    const long long blocks = (count + 255) / 256;
    split_reps_kernel<<<static_cast<unsigned int>(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
        reps, tiles, u, cc, kc, bn, (cc + kc - 1) / kc, count);
  }
  return reinterpret_cast<uintptr_t>(tiles) % 16 != 0 ? static_cast<int>(cudaErrorMisalignedAddress)
                                                        : static_cast<int>(cudaSuccess);
}

// f(vec, resident) with the route as two std::integral_constants: 16-byte
// row copies where every row is whole 16-byte pieces from an aligned base,
// and the rows resident for all user tiles where they fit shared memory
// with the epilogue's red_bytes (for red_bytes = 16 KB: cc <= 144 in f32,
// <= 272 in bf16).
template <typename RowT, typename F>
int with_route(const RowT* rows, int cc, int red_bytes, F&& f) {
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  const bool resident =
      smem_bytes<RowT>(true, (cc + KC - 1) / KC * KC, red_bytes) <= static_cast<size_t>(optin);
  const bool vec = cc % RowTile<RowT>::kVecElems == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  using T = std::true_type;
  using F0 = std::false_type;
  if (vec) return resident ? f(T{}, T{}) : f(T{}, F0{});
  return resident ? f(F0{}, T{}) : f(F0{}, F0{});
}

// Scores of the block's rows [r0, r0 + BM) against every user tile, from
// the split reps `tiles`, into each thread's 64 accumulators (the fragment
// above). After a user tile's last k-slice every thread calls
// epilogue(tile, acc, red): it must leave acc zeroed, and may use red
// (red_bytes of shared memory) behind one __syncthreads a tile, which its
// double buffering across tiles needs (tile % 2).
template <typename RowT, bool kVec, bool kResident, typename Epilogue>
__device__ __forceinline__ void run(const RowT* __restrict__ rows, const float* __restrict__ tiles,
                                    int64_t c, int cc, int u, int64_t r0, unsigned char* smem,
                                    int red_bytes, Epilogue&& epilogue) {
  using Tile = RowTile<RowT>;
  constexpr bool kExact = sizeof(RowT) == 2;  // bf16 is exact in TF32: a_lo = 0
  constexpr int kSlots = kResident ? kResidentSlots : kStreamSlots;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row_w = warp * 16;  // this warp's 16 rows; warpgroup warp / 4
  const int n_k = (cc + KC - 1) / KC;
  const int n_tiles = (u + BN - 1) / BN;
  const int total = n_k * n_tiles;
  const int a_stride = (kResident ? n_k * KC : KC) + Tile::kPad;
  const size_t a_size = kResident ? a_bytes<RowT>(n_k * KC) : a_bytes<RowT>(KC);
  // Slot s: [rows slice, streamed only][reps hi | lo].
  const size_t slot_size = (kResident ? 0 : a_size) + kSlotB;
  unsigned char* ring = smem + (kResident ? a_size : 0);
  unsigned char* red = ring + kSlots * slot_size;
  uint64_t* full = reinterpret_cast<uint64_t*>(red + red_bytes);
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
      if (it % n_k == n_k - 1) epilogue(it / n_k, acc, red);
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
      if (it % n_k == n_k - 1) epilogue(it / n_k, acc, red);
    }
  }
}

// The rows-on-N tile, for narrow rows: users on the wgmma's M (A, the split
// reps, from shared memory), table rows on its N (B, split once a block in
// shared memory). A persistent block walks row blocks of kRows rows; for
// each, warpgroup wg scores rows [128 (wg & 1), + 128) of it against user
// tiles (wg >> 1), + 2, ... of kUsers users, so a pair of warpgroups shares
// each reps tile (a ring of kSlots, refilled by the pair's first thread
// while its wgmmas run). Where both pairs take as many tiles, they take
// turns to issue a tile's wgmmas (two mbarriers), so one pair's epilogue
// runs under the other's tensor work (4-6 % of K4 at 50M x 33, the H100).
// The next row block's raw rows arrive by one bulk copy into a stage while
// the current one is scored, and each thread splits 4 k of one row at a
// time into 16-byte stores (split element by element, a 1-user call at 50M
// x 33 took 7.4 ms; four at a time, 4.7 ms). See score_submax_tc.cu.
namespace narrow {

constexpr int kRows = BM;      // table rows of a block's step: a warpgroup pair's two halves
constexpr int kHalf = 128;     // rows a warpgroup scores: the wgmma's N
constexpr int kUsers = 64;     // users of a tile: the wgmma's M
constexpr int kSlots = 2;      // reps tiles in flight for each pair
constexpr int kBarBytes = 96;  // 2 pairs x kSlots x (full, empty), the rows', 2 turns; 16-byte rounded
constexpr int kLboA = kUsers * 16;  // bytes between 4-k chunks of a reps tile: 1024
constexpr int kLboB = kRows * 16;   // of the block's rows: 4096

__host__ __device__ constexpr int depth(int cc) { return (cc + 7) / 8 * 8; }  // whole k-steps
// Shared memory, in this order: the block's rows split (hi, and lo for f32
// rows; bf16 is exact in TF32) in wgmma's K-major layout, 2 x kSlots reps
// tiles, the raw rows of the next block (+16 bytes: a misaligned start),
// kBarBytes of barriers. The launch takes the sum from its caller
// (ops/topk_kernels.py rows_on_n_smem_bytes).
template <typename RowT>
__host__ __device__ constexpr size_t rows_bytes(int cc) {
  return (sizeof(RowT) == 2 ? 1 : 2) * static_cast<size_t>(kRows) * depth(cc) * 4;
}
__host__ __device__ constexpr size_t slot_bytes(int cc) { return 2 * static_cast<size_t>(kUsers) * depth(cc) * 4; }
template <typename RowT>
__host__ __device__ constexpr size_t stage_bytes(int cc) {
  return static_cast<size_t>(kRows) * cc * sizeof(RowT) + 16;
}

// The split reps of this tile: one contiguous [hi | lo] block of
// slot_bytes(cc) per tile of kUsers users, the whole depth in one slice.
inline long long scratch_floats(int u, int cc) { return score_tile::scratch_floats(u, cc, depth(cc), kUsers); }
inline int split(const float* reps, float* tiles, int u, int cc, cudaStream_t stream) {
  return split_reps(reps, tiles, u, cc, stream, depth(cc), kUsers);
}

// Scores of rows [0, c) against the users of the split reps `tiles`, with
// gridDim.x persistent blocks of kThreads. After each user tile the
// warpgroup, on its own, calls epilogue(row0, tile, acc): its rows are
// [row0, row0 + 128), and acc holds its 64 accumulators, users
// tile * kUsers + 16 (warp % 4) + g (+ 8) at acc[4 j + {0, 1}] ({2, 3}),
// rows row0 + 8 j + 2 t (+ 1) (tf32x3.cuh's layout with M and N swapped
// in meaning). The next tile's first wgmma overwrites acc. No barrier
// joins the warpgroups inside a row block; two __syncthreads a row block
// hand the shared rows over.
template <typename RowT, typename Epilogue>
__device__ __forceinline__ void run(const RowT* __restrict__ rows, const float* __restrict__ tiles, int64_t c,
                                    int cc, int u, unsigned char* smem, Epilogue&& epilogue) {
  using Tile = RowTile<RowT>;
  constexpr bool kExact = sizeof(RowT) == 2;  // bf16 rows: lo = 0, 2 products a term
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int half = wg & 1;
  const int pair = wg >> 1;
  const int ccp = depth(cc);
  const int n_ks = ccp / 8;
  const int n_tiles = (u + kUsers - 1) / kUsers;
  const int my_tiles = (n_tiles - pair + 1) / 2;  // tiles pair, pair + 2, ...
  const int64_t n_blocks = (c + kRows - 1) / kRows;
  const int64_t my_blocks =
      static_cast<int64_t>(blockIdx.x) < n_blocks ? (n_blocks - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int64_t my_items = my_blocks * my_tiles;  // this pair's reps tiles, in order
  const size_t part = static_cast<size_t>(kRows) * ccp * 4;  // the rows' hi (or lo)
  const size_t slot_size = slot_bytes(cc);
  unsigned char* ring = smem + rows_bytes<RowT>(cc);
  unsigned char* stage = ring + 2 * kSlots * slot_size;
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + stage_bytes<RowT>(cc));  // [pair][slot]
  uint64_t* empty = full + 2 * kSlots;
  uint64_t* rows_full = empty + 2 * kSlots;
  uint64_t* turn = rows_full + 1;  // [pair]: the other pair has issued its tile
  // Where both pairs take as many tiles, they take turns to issue a tile's
  // wgmmas, so one pair's epilogue runs under the other's tensor work.
  const bool alternate = n_tiles % 2 == 0;
  uint64_t* my_full = full + pair * kSlots;
  uint64_t* my_empty = empty + pair * kSlots;
  unsigned char* my_ring = ring + pair * kSlots * slot_size;
  const bool producer = tid == 256 * pair;  // the first thread of the pair's half-0 warpgroup

  // Item `item` of the pair: user tile pair + 2 (item % my_tiles), into its slot.
  auto load_item = [&](int64_t item) {
    const int s = static_cast<int>(item % kSlots);
    const int64_t tile = pair + 2 * (item % my_tiles);
    bulk_copy(my_ring + s * slot_size, tiles + tile * static_cast<int64_t>(slot_size / 4),
              static_cast<uint32_t>(slot_size), my_full + s);
  };
  // Row block rb's bytes [s, e) of the table, and their 16-byte-aligned
  // middle [a, b) that one bulk copy brings into the stage.
  auto span = [&](int64_t rb, uintptr_t& s, uintptr_t& a, uintptr_t& b, int& count) {
    const int64_t r0 = rb * kRows;
    count = static_cast<int>((c - r0 < kRows ? c - r0 : kRows) * cc);
    s = reinterpret_cast<uintptr_t>(rows + r0 * cc);
    a = (s + 15) & ~static_cast<uintptr_t>(15);
    b = (s + static_cast<uintptr_t>(count) * sizeof(RowT)) & ~static_cast<uintptr_t>(15);
  };
  auto fetch_rows = [&](int64_t rb) {
    uintptr_t s, a, b;
    int count;
    span(rb, s, a, b, count);
    if (b > a)
      bulk_copy(stage + (a - (s & ~static_cast<uintptr_t>(15))), reinterpret_cast<const void*>(a),
                static_cast<uint32_t>(b - a), rows_full);
    else
      mbar_arrive(rows_full);
  };

  if (tid == 0) {
    for (int i = 0; i < 2 * kSlots; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 2);  // the pair's two warpgroups
    }
    mbar_init(rows_full, 1);
    mbar_init(turn, 8);  // the other pair's 8 warps
    mbar_init(turn + 1, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Zeros in rows past c.
  for (size_t i = tid; i < rows_bytes<RowT>(cc) / 16; i += kThreads)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0 && my_blocks > 0) fetch_rows(blockIdx.x);
  if (producer)
    for (int64_t i = 0; i < kSlots && i < my_items; ++i) load_item(i);

  const uint64_t b_hi = tf32x3::smem_desc(smem + half * (kHalf / 8) * 128, kLboB, 128);
  const uint64_t b_lo = b_hi + (part >> 4);  // descriptors count addresses in 16-byte units
  float acc[64];
  int64_t item = 0;
  for (int64_t j = 0; j < my_blocks; ++j) {
    const int64_t rb = blockIdx.x + j * gridDim.x;
    // The staged rows, split into hi and lo in the K-major layout: [k chunk]
    // [row / 8][row % 8][k % 4], a thread per (chunk, row): four loads of
    // the raw row (a stride of cc words across the warp: no bank
    // conflicts) and one 16-byte store of each part (zeros past cc). Where
    // the aligned copy left out the block's head or tail bytes, those come
    // from device memory.
    mbar_wait(rows_full, static_cast<int>(j & 1));
    {
      uintptr_t s, a, b;
      int count;
      span(rb, s, a, b, count);
      const RowT* staged = reinterpret_cast<const RowT*>(stage + (s & 15));
      const RowT* src = rows + rb * kRows * cc;
      const bool whole = a == s && b == s + static_cast<uintptr_t>(count) * sizeof(RowT);
      const int n_rows = count / cc;
      float4* dst = reinterpret_cast<float4*>(smem);
      for (int i = tid; i < ccp / 4 * kRows; i += kThreads) {
        const int m = i % kRows;
        if (m >= n_rows) continue;
        const int k0 = i / kRows * 4;
        float x[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e = m * cc + k0 + q;
          const uintptr_t at = s + static_cast<uintptr_t>(e) * sizeof(RowT);
          x[q] = k0 + q >= cc ? 0.0f
                 : whole || (at >= a && at < b) ? Tile::get(staged, e)
                                                 : Tile::get(src, e);
        }
        if constexpr (kExact) {
          dst[i] = make_float4(x[0], x[1], x[2], x[3]);
        } else {
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) tf32x3::split(x[q], hi[q], lo[q]);
          dst[i] = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]), __uint_as_float(hi[2]),
                               __uint_as_float(hi[3]));
          dst[part / 16 + i] = make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]), __uint_as_float(lo[2]),
                                           __uint_as_float(lo[3]));
        }
      }
    }
    // The rows are the tensor cores' to read; the stage is the copy engine's.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0 && j + 1 < my_blocks) fetch_rows(rb + gridDim.x);

    for (int q = 0; q < my_tiles; ++q, ++item) {
      const int s = static_cast<int>(item % kSlots);
      mbar_wait(my_full + s, static_cast<int>((item / kSlots) & 1));
      if (alternate && (pair == 1 || item > 0))
        mbar_wait(turn + pair, static_cast<int>((pair == 0 ? item - 1 : item) & 1));
      __syncwarp();  // wgmma's .aligned instructions need the warp converged
      const uint64_t a_hi = tf32x3::smem_desc(my_ring + s * slot_size, kLboA, 128);
      const uint64_t a_lo = a_hi + (slot_size / 2 >> 4);
      tf32x3::wgmma_fence();
      // The cross products first, then hi * hi (tf32x3.cuh); the tile's
      // first product overwrites the accumulators, so they are dead from
      // the last epilogue's reads to here.
      if constexpr (kExact) {
        tf32x3::wgmma_m64n128k8_ss_first(acc, a_lo, b_hi);
      } else {
        tf32x3::wgmma_m64n128k8_ss_first(acc, a_hi, b_lo);
        tf32x3::wgmma_m64n128k8_ss(acc, a_lo, b_hi);
      }
      tf32x3::wgmma_m64n128k8_ss(acc, a_hi, b_hi);
      for (int ks = 1; ks < n_ks; ++ks) {
        const uint64_t da = 2 * ks * kLboA >> 4;
        const uint64_t db = 2 * ks * kLboB >> 4;
        if constexpr (!kExact) tf32x3::wgmma_m64n128k8_ss(acc, a_hi + da, b_lo + db);
        tf32x3::wgmma_m64n128k8_ss(acc, a_lo + da, b_hi + db);
        tf32x3::wgmma_m64n128k8_ss(acc, a_hi + da, b_hi + db);
      }
      tf32x3::wgmma_commit();
      if (alternate && tid % 32 == 0) mbar_arrive(turn + (1 - pair));
      // While they run: the slot of the previous item, once both warpgroups
      // have released it, takes the item kSlots past it.
      if (producer && item >= 1 && item - 1 + kSlots < my_items) {
        mbar_wait(my_empty + (item - 1) % kSlots, static_cast<int>(((item - 1) / kSlots) & 1));
        load_item(item - 1 + kSlots);
      }
      __syncwarp();
      tf32x3::wgmma_wait_all();
      tf32x3::keep_in_registers(acc);
      if (tid % 128 == 0) mbar_arrive(my_empty + s);
      epilogue(rb * kRows + half * kHalf, pair + 2 * q, acc);
    }
    __syncthreads();  // every warpgroup is done with the block's rows
  }
}

}  // namespace narrow

}  // namespace score_tile
