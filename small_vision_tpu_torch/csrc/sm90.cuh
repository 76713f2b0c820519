// Hopper (sm_90a) building blocks shared by the kernels that feed the
// tensor cores asynchronously: mbarriers, TMA tile copies, warpgroup matrix
// products (wgmma) with their shared-memory descriptors, and the host-side
// encoding of a tensor map.
//
// Conventions.
//  - A tile is 64 rows of 64 bf16 (128 bytes a row), 8 KB, written by TMA
//    with the 128-byte swizzle: the 16-byte chunk j of row r lands at chunk
//    j ^ (r % 8) of that row. Tiles start on 1024-byte boundaries, so the
//    swizzle's phase is the address's and wgmma reads the same pattern. A
//    swizzle only permutes chunks within a 128-byte row, so the row of any
//    byte offset in a tile is offset / 128.
//  - The same tile serves as a "K-major" operand (its 64 columns are the
//    contraction: A = rows x 64, or B = (rows as N) x 64) and as an
//    "MN-major" B operand (its rows are the contraction, its 64 columns N),
//    through two descriptors (`desc_k_major`, `desc_mn_major`) and the
//    instruction's transpose-B bit.
//  - wgmma m64nNk16's f32 accumulator in warp w of the warpgroup, lane
//    (g = lane / 4, t4 = lane % 4): d[4 n + 0, 1] = D[16 w + g][8 n + 2 t4
//    + 0, 1], d[4 n + 2, 3] = D[16 w + g + 8][same], the (m16, n8) layout of
//    mma.sync. The A operand from registers takes the m16n8k16 A fragment
//    of rows 16 w .. 16 w + 15. So the accumulators of n-tiles 2 j, 2 j + 1,
//    packed to bf16 pairs, are the A registers of contraction step j of the
//    next product.
//  - Registers written by a wgmma are valid only after wgmma_wait; `fence`
//    ties them to that point so the compiler does not move reads above it.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int kTileRows = 64;
constexpr int kTileBytes = kTileRows * 128;  // 64 x 64 bf16

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (dynamic shared memory is
// only 16-byte aligned; the caller allocates 1 KB more).
__device__ __forceinline__ uint8_t* align_tiles(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// ---- mbarriers -----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes initialised barriers visible to the other threads and to TMA.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrives and adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// mbar_arrive / mbar_arrive_expect_tx where `pred` holds, predicated in
// the instruction (no branch).
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(static_cast<int>(pred))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx_if(uint64_t* bar,
                                                         uint32_t bytes,
                                                         bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(bytes), "r"(static_cast<int>(pred))
      : "memory");
}

// A ring of kStages shared-memory stages that its consumer threads fill in
// order by TMA and release: load n goes to stage n % kStages. full[s]
// takes one arrival, the copying thread's with the bytes it expects, and
// completes its phase n / kStages when load n has landed; empty[s] takes
// one arrival from each consumer warp once it is done with the stage, and
// completes that phase when all have. A stage is refilled only after its
// previous load is released, so neither barrier runs two phases ahead of a
// waiter and one parity bit tells the phases apart.
//
// Every consumer thread waits for every use in order, and each wait first
// issues the load kAhead = kStages - 2 uses further (a consumer holds at
// most its last use and the one it waits for, so that load's stage is
// freed by releases its own warp has made). The code is straight: the
// load's copies are predicated in their instructions (the `_if` forms) on
// the copying thread and on the load's existence, and the first kStages
// loads wait on empty barriers that are fresh (parity 1 passes at once).
// A thread-dependent branch inside a wgmma pipeline makes ptxas serialise
// the products (C7520).
template <int kStages>
struct Ring {
  static constexpr int kAhead = kStages - 2;
  uint64_t* full;
  uint64_t* empty;

  __device__ void init(int consumer_warps) const {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumer_warps);
    }
  }
  __device__ int stage(int n) const { return n % kStages; }
  // Loads 0 .. kAhead - 1, before any wait: load(m, stage, &full[stage],
  // issue) with issue = whether load m exists (below `total`).
  template <class Load>
  __device__ void prime(int total, Load&& load) const {
#pragma unroll
    for (int m = 0; m < kAhead; ++m) load(m, m, &full[m], m < total);
  }
  // Use n: issues load n + kAhead once its stage is free, then waits for
  // use n to land.
  template <class Load>
  __device__ void wait(int n, int total, Load&& load) const {
    const int m = n + kAhead;
    const int s = m % kStages;
    // Phase m / kStages - 1 of empty[s]: the release of load m - kStages.
    mbar_wait(&empty[s], ((m / kStages) + 1) & 1);
    load(m, s, &full[s], m < total);
    mbar_wait(&full[n % kStages], (n / kStages) & 1);
  }
  // This warp is done with use n (its lane 0 arrives).
  __device__ void release(int n, int lane) const {
    mbar_arrive_if(&empty[n % kStages], lane == 0);
  }
  // release(n, lane) where `pred` holds, predicated, with no branch (a
  // branch around it in the wgmma pipeline made ptxas serialise the
  // products of the wide-head attention kernels, C7520).
  __device__ void release_if(int n, int lane, bool pred) const {
    mbar_arrive_if(&empty[n % kStages], lane == 0 && pred);
  }
};

// ---- TMA -----------------------------------------------------------------

// One box of a 3-D tensor map into shared memory; completion is counted on
// `bar` in bytes. Coordinates are innermost first.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One box of a 4-D tensor map into shared memory (see `tma_load_3d`).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// tma_load_4d where `pred` holds, predicated in the instruction.
__device__ __forceinline__ void tma_load_4d_if(void* dst,
                                               const CUtensorMap* map,
                                               uint64_t* bar, int c0, int c1,
                                               int c2, int c3, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %7, 0;\n"
      "@p cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      "}\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(static_cast<int>(pred))
      : "memory");
}

// Orders this thread's ordinary shared-memory stores before later reads of
// the same bytes by wgmma or TMA (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `kId` (1..15) over `threads` threads, e.g. one warpgroup.
template <int kId>
__device__ __forceinline__ void named_barrier(int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kId), "r"(threads) : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Descriptor of a 128-byte-swizzled tile (layout type 1 in bits 62-63):
// start address, leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

// The tile's 64 columns are the contraction. Groups of 8 rows lie 1024
// bytes apart; step ks of 16 columns starts 32 bytes further (+2 units).
__device__ __forceinline__ uint64_t desc_k_major(const void* tile) {
  return make_desc(smem_u32(tile), 16, 1024);
}
constexpr uint64_t kKMajorStep = 2;

// The tile's rows are the contraction and its 64 columns are N (B only,
// with the transpose-B bit): 8 contraction rows a 1024-byte group, and N
// fits one 64-column swizzle atom, so both offsets are that group's stride.
// Step ks of 16 rows starts 2048 bytes further (+128 units).
__device__ __forceinline__ uint64_t desc_mn_major(const void* tile) {
  return make_desc(smem_u32(tile), 1024, 1024);
}
constexpr uint64_t kMNMajorStep = 128;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

template <int N>
__device__ __forceinline__ void fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SM90_D32(i)                                                        \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define SM90_D_LIST                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// D (64 x 64, f32) = [D +] A B, A and B from shared memory, both K-major
// (D = A_tile . B_tile^T over the 16 columns the descriptors point at).
// `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : SM90_D32(0), SM90_D32(8), SM90_D32(16), SM90_D32(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) = [D +] A B, A (64 x 16 bf16) from registers in the
// m16n8k16 fragment layout, B from an MN-major shared tile (transpose-B).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : SM90_D32(0), SM90_D32(8), SM90_D32(16), SM90_D32(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

#undef SM90_D32
#undef SM90_D_LIST

// S (64 x 64) [+]= A_tile B_tile^T over all 64 columns: four k16 steps.
__device__ __forceinline__ void gemm_nt(float (&d)[32], uint64_t da,
                                        uint64_t db,
                                        bool accumulate = false) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    wgmma_ss(d, da + ks * kKMajorStep, db + ks * kKMajorStep,
             accumulate || ks > 0);
  }
}

// D (64 x 64) [+]= P B_tile over the tile's 64 rows: P (64 x 64 bf16) in
// A registers, four k16 steps of 4 registers each.
__device__ __forceinline__ void gemm_rn(float (&d)[32],
                                        const uint32_t (&p)[16], uint64_t db,
                                        bool accumulate) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint32_t a[4] = {p[4 * ks], p[4 * ks + 1], p[4 * ks + 2],
                           p[4 * ks + 3]};
    wgmma_rs(d, a, db + ks * kMNMajorStep, accumulate || ks > 0);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return v;
}

// The A operand of a following product (16 registers, bf16 pairs) from a
// 64 x 64 f32 accumulator: contraction step j takes n-tiles 2 j and 2 j + 1.
__device__ __forceinline__ void pack_a(uint32_t (&p)[16],
                                       const float (&d)[32]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p[4 * j + 0] = pack_bf16(d[8 * j + 0], d[8 * j + 1]);
    p[4 * j + 1] = pack_bf16(d[8 * j + 2], d[8 * j + 3]);
    p[4 * j + 2] = pack_bf16(d[8 * j + 4], d[8 * j + 5]);
    p[4 * j + 3] = pack_bf16(d[8 * j + 6], d[8 * j + 7]);
  }
}

// Stores rows `row` and `row + 8` of a warpgroup's 64 x 64 f32 accumulator
// (this thread's part, columns 8 n + 2 t4) as bf16 times f_lo / f_hi into a
// row-major matrix with `ld` elements a row, dropping rows at or past
// `rows` and columns at or past `cols` (a multiple of 8).
__device__ __forceinline__ void store_acc(__nv_bfloat16* out, size_t ld,
                                          int row, int rows,
                                          const float (&d)[32], float f_lo,
                                          float f_hi, int t4,
                                          int cols = 64) {
  __nv_bfloat16* lo = out + static_cast<size_t>(row) * ld + 2 * t4;
  __nv_bfloat16* hi = lo + 8 * ld;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (8 * n >= cols) break;
    if (row < rows) {
      *reinterpret_cast<uint32_t*>(lo + 8 * n) =
          pack_bf16(d[4 * n] * f_lo, d[4 * n + 1] * f_lo);
    }
    if (row + 8 < rows) {
      *reinterpret_cast<uint32_t*>(hi + 8 * n) =
          pack_bf16(d[4 * n + 2] * f_hi, d[4 * n + 3] * f_hi);
    }
  }
}

// ---- wide heads: a ring of tile pairs --------------------------------------
//
// Heads of more than four 64-column tiles (D > 256) stream every operand
// through one ring of 16 KB stages, each two tiles, the first at the stage
// and the second 8 KB further: a pair of the contraction over D (tile c of
// Q and of K, or of dO and of V) or two column tiles of one operand. The
// kernels that run it are one warpgroup a CTA, two CTAs an SM, and fill it
// by Ring's predicated copies (no producer warp: its registers would come
// from the accumulators).
constexpr int kPairStages = 6;
constexpr int kPairBytes = 2 * kTileBytes;
using PairRing = Ring<kPairStages>;

// A head's 64-column tiles.
__host__ __device__ constexpr int head_tiles(int head_dim) {
  return (head_dim + 63) / 64;
}

// 1 KB to align the tiles, the stages, and a full and an empty barrier
// each.
__host__ __device__ constexpr size_t pair_ring_smem() {
  return 1024 + static_cast<size_t>(kPairStages) * kPairBytes +
         16 * kPairStages;
}
static_assert(2 * (pair_ring_smem() + 1024) <= 233472, "two CTAs an SM");

// A CTA's ring over its aligned shared memory: the stages, then the full
// and the empty barriers.
__device__ __forceinline__ PairRing pair_ring(uint8_t* smem) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kPairStages *
                                               kPairBytes);
  return PairRing{full, full + kPairStages};
}

// Ring use n's first tile.
__device__ __forceinline__ uint8_t* pair_tile(uint8_t* smem, int n) {
  return smem + (n % kPairStages) * kPairBytes;
}

// One use's copies, issued by thread 0 where `copy` holds (predicated):
// tile c0 of head h of map a at `row` into the stage's first tile and tile
// c1 of head hb of map b at `row_b` into its second, the barrier expecting
// what is copied. A tile whose column tile is at or past nd is not copied
// (its stale products fill accumulator columns that no store keeps).
__device__ __forceinline__ void pair_load(uint8_t* dst, uint64_t* bar,
                                          const CUtensorMap* a, int c0,
                                          int h, int row,
                                          const CUtensorMap* b, int c1,
                                          int hb, int row_b, int batch,
                                          int nd, bool copy) {
  const bool la = c0 < nd;
  const bool lb = c1 < nd;
  mbar_arrive_expect_tx_if(bar, (la + lb) * kTileBytes, copy);
  tma_load_4d_if(dst, a, bar, c0 * 64, h, row, batch, copy && la);
  tma_load_4d_if(dst + kTileBytes, b, bar, c1 * 64, hb, row_b, batch,
                 copy && lb);
}

// Products of the contraction over a head's nd column tiles: for c = 0 ..
// nd - 1 and w < kPer, ring use n0 + kPer c + w holds tile c of both
// operands and `product(w, tiles, c > 0)` issues acc_w [+]= A_c B_c^T on
// them (kPer 1: S; 2: S and dP, alternating). Each use is its own commit
// group: the wait after it lets the one before finish and releases its
// use (the use before n0 too where `prev_held`: the caller's product in
// flight on it), so that a warp holds at most the use it waits for and
// the one before, as Ring needs. Returns with every product landed and
// every use released; the caller fences its accumulators.
template <int kPer, class Load, class Product>
__device__ __forceinline__ void pair_products(const PairRing& ring,
                                              uint8_t* smem, int n0, int nd,
                                              int total, Load&& load,
                                              Product&& product, int lane,
                                              bool prev_held) {
  for (int c = 0; c < nd; ++c) {
#pragma unroll
    for (int w = 0; w < kPer; ++w) {
      const int n = n0 + kPer * c + w;
      ring.wait(n, total, load);
      wgmma_fence();
      product(w, pair_tile(smem, n), c > 0);
      wgmma_commit();
      wgmma_wait<1>();
      ring.release_if(n > 0 ? n - 1 : 0, lane, n > n0 || prev_held);
    }
  }
  wgmma_wait<0>();
  ring.release(n0 + kPer * nd - 1, lane);
}

}  // namespace sm90

// ---- host: tensor maps -----------------------------------------------------

namespace sm90_host {

// cuTensorMapEncodeTiled is a driver function; the libraries link the
// runtime only, so it is looked up through the runtime's entry-point query
// (whose signature gained an argument in CUDA 12.5).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) != cudaSuccess) {
      p = nullptr;
    }
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Tensor map over the packed (B, L, H*D) bf16 layout of any head dim D (a
// multiple of 8), viewed as (D, H, L, B) innermost first, box (64, 1, 64,
// 1) with the 128-byte swizzle: one box is 64 columns, from `c0`, of one
// head's 64 rows of one batch element, the 8 KB tile of the other maps.
// Columns at or past D (the head's, not the row's: the next head's
// columns lie past the map's first dimension) and rows at or past L are
// out of bounds and arrive as zeros. A head of D <= 64 is one box, of 64 <
// D <= 128 two (c0 = 0, 64). Returns false if it cannot be made.
inline bool packed_head_map_d(CUtensorMap* map, const void* base, int batch,
                              int seq_len, int num_heads, int head_dim) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t hd = static_cast<cuuint64_t>(head_dim);
  const cuuint64_t width = static_cast<cuuint64_t>(num_heads) * hd;
  const cuuint64_t dims[4] = {hd, static_cast<cuuint64_t>(num_heads),
                              static_cast<cuuint64_t>(seq_len),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {hd * 2, width * 2, width * 2 * seq_len};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90_host
