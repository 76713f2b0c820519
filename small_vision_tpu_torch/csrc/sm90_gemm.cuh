// Hopper (sm_90a) pieces beside sm90.cuh: 2-D TMA copies both ways (stores
// from swizzled tiles), the m64n128k16 product whose MN-major B spans two
// 64-column swizzle atoms, ex2 and a reciprocal without the denormal
// handling, the host's 2-D and strided 3-D tensor maps, and the persistent
// bias GEMM that K6's projections and K5's two products run on.
//
// An MN-major B of 128 columns is two 64 x 64 tiles (two TMA boxes) one
// after the other: in its descriptor the leading byte offset is the step
// from one 64-column atom to the next (8 KB), the stride byte offset the
// step from one group of 8 contraction rows to the next (1024 bytes).

#pragma once

#include "sm90.cuh"

namespace sm90 {

#define SM90G_D8(i)                                                       \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// One box of a 2-D tensor map into shared memory; completion is counted on
// `bar` in bytes. Coordinates are innermost first.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// One box of shared memory to a 2-D tensor map: a bulk group of
// this thread's, committed by bulk_commit. Elements out of bounds are not
// written. The shared bytes must have been made visible to the async
// proxy (fence_proxy_async, then a barrier) by the threads that wrote them.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(map),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most kPending of this thread's bulk groups still read
// shared memory (their sources may then be written again).
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending)
               : "memory");
}

// Waits until at most kPending of this thread's bulk groups are incomplete.
template <int kPending>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Stores the pair (lo, hi) as bf16 at row r, columns c, c + 1 (c even) of
// a 64 x 64 tile laid out as TMA's 128-byte swizzle.
__device__ __forceinline__ void st_swizzled(uint8_t* tile, int r, int c,
                                            float lo, float hi) {
  *reinterpret_cast<uint32_t*>(tile + r * 128 +
                               (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2) =
      pack_bf16(lo, hi);
}

// Two MN-major 64 x 64 tiles side by side as one B of N = 128.
__device__ __forceinline__ uint64_t desc_mn_major_n128(const void* tile) {
  return make_desc(smem_u32(tile), kTileBytes, 1024);
}

// D (64 x 128, f32) = [D +] A B, A K-major from shared memory, B MN-major
// (transpose-B). The accumulator's layout is wgmma_ss's, 16 n-tiles of 8.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : SM90G_D8(0), SM90G_D8(8), SM90G_D8(16), SM90G_D8(24),
        SM90G_D8(32), SM90G_D8(40), SM90G_D8(48), SM90G_D8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef SM90G_D8

// 2^x by the SFU alone (denormal results flush to zero).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 1 / x by the SFU alone (0 for an infinite x).
__device__ __forceinline__ float rcp_ftz(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Barrier over the 128 threads of warpgroup `wg` (0 or 1).
__device__ __forceinline__ void wg_barrier(int wg) {
  if (wg == 0) {
    named_barrier<1>(128);
  } else {
    named_barrier<2>(128);
  }
}

// ---- the persistent bias GEMM --------------------------------------------
//
// C_w = bf16(Epi(f32(A W_w) + b_w)) for w < num_w: A (m, k), each W_w
// (k, n) and C_w (m, n) row-major bf16 behind their tensor maps (A's box
// 128 x 64, W's and C's 64 x 64, all with the 128-byte swizzle), biases
// (n,) bf16; k and n multiples of 8 (a TMA row stride is a multiple of 16
// bytes), m any count. TMA brings what lies past the matrices as zeros:
// A's rows past m, and in the last of the ceil(k / 64) stages A's columns
// and W's rows past k, whose products add exact zeros to the f32 sums; a
// box wider than its matrix (k or n under 64) is filled the same way, and
// the stage's barrier still counts the whole box's bytes. The stores
// leave out rows past m and columns past n, and the bias is read in
// pairs below n (even, as n is). Where k and n are multiples of 64 nothing
// lies past them: the same products in the same order as before the tails
// were taken. Epi maps the f32 sum before its one rounding.
//
// Design. One persistent CTA a SM walks 128 x 128 output tiles,
// row block outermost, so the CTAs in flight share their A rows in L2. Its
// producer warp keeps a ring of kStages 64-deep stages full by TMA, in the
// order of its tiles (A: one 128 x 64 box; W: two boxes of 64 x 64,
// read MN-major through the transpose-B bit), each stage with a "full" and
// an "empty" mbarrier. Two consumer warpgroups take the tiles, in one of
// two schedules:
//  - cooperative: each takes 64 rows of every tile;
//  - ping-pong: each takes whole tiles of its own, in turn (warpgroup 0
//    the CTA's 1st, 3rd, ... tiles), so one's epilogue runs while the
//    other's products do. A warpgroup starts its next tile only after
//    the other has waited out every stage of the tile before (a "turn"
//    mbarrier each), so no stage it waits for can be two phases ahead.
// A warpgroup keeps one stage's m64n128k16 products in flight while it
// issues the next stage's. The epilogue runs in f32 on the accumulator;
// the tile goes as bf16 into the warpgroup's swizzled shared boxes and out
// by TMA stores, which run on while the next tile's products do. Each
// output is one sum in a fixed k order (no split-K, no atomics), so two
// launches give the same bits, under either schedule.

struct BiasOnly {
  __device__ __forceinline__ static float apply(float v) { return v; }
};

// tanh-gelu by 0.5 (1 + tanh(u)) = 1 / (1 + e^(-2u)): one ex2 and one
// reciprocal a value, within a few f32 ulps of x * 0.5 (1 + tanhf(u)).
// Saturated as tanhf is: past u > 8.4, 1 + e^(-2u) rounds to 1 and the
// result is x; below u < -9.1, where tanhf(u) is -1, it is 0.
struct BiasGeluTanh {
  __device__ __forceinline__ static float apply(float x) {
    const float u = 0.7978845608028654f * (x + 0.044715f * (x * x * x));
    const float s = rcp_ftz(1.f + exp2_ftz(-2.8853900817779268f * u));
    return x * (u < -9.1f ? 0.f : s);
  }
};

template <bool kPingPong_ = false>
struct GemmTiles {
  static constexpr int kBM = 128;
  static constexpr int kBN = 128;
  static constexpr int kBK = 64;
  static constexpr int kStages = 5;
  static constexpr bool kPingPong = kPingPong_;
  // Rows of a tile one warpgroup computes.
  static constexpr int kWgRows = kPingPong ? kBM : kBM / 2;
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kStageBytes = kABytes + kBK * kBN * 2;
  // A warpgroup's kWgRows x kBN output, as swizzled 64 x 64 boxes.
  static constexpr int kOutBytes = kWgRows * kBN * 2;
  static constexpr size_t kSmem =
      1024 + kStages * kStageBytes + 2 * kOutBytes + 16 * kStages + 16;
};

constexpr int kGemmConsumers = 256;                 // two warpgroups
constexpr int kGemmThreads = kGemmConsumers + 32;  // and one producer warp

// The body of a GEMM kernel of kGemmThreads threads and T::kSmem bytes of
// dynamic shared memory (`smem_raw`); the maps are the kernel's
// __grid_constant__ parameters. Unused W_w, C_w, b_w (w >= num_w) are not
// read.
template <class Epi, class T>
__device__ __forceinline__ void gemm_bias_tiles(
    uint8_t* smem_raw, const CUtensorMap* tm_a, const CUtensorMap* tm_w0,
    const CUtensorMap* tm_w1, const CUtensorMap* tm_w2,
    const CUtensorMap* tm_c0, const CUtensorMap* tm_c1,
    const CUtensorMap* tm_c2, const __nv_bfloat16* __restrict__ b0,
    const __nv_bfloat16* __restrict__ b1,
    const __nv_bfloat16* __restrict__ b2, int m, int n, int k, int num_w) {
  constexpr int kBM = T::kBM, kBN = T::kBN, kBK = T::kBK;
  constexpr int kStages = T::kStages, kStageBytes = T::kStageBytes;
  constexpr int kMB = T::kWgRows / 64;  // 64-row blocks a warpgroup computes
  uint8_t* smem = align_tiles(smem_raw);
  // Warpgroup w's output boxes at out_s + w * kOutBytes.
  uint8_t* out_s = smem + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_s + 2 * T::kOutBytes);
  uint64_t* empty = full + kStages;
  uint64_t* turn = empty + kStages;  // ping-pong: warpgroup w's turn
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_per_w = (n + kBN - 1) / kBN;
  const int n_tiles = num_w * n_per_w;
  const int tiles = (m + kBM - 1) / kBM * n_tiles;
  const int k_steps = (k + kBK - 1) / kBK;  // the last one zero-filled past k

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      // A stage is handed back by lane 0 of each warp that read it.
      mbar_init(&empty[s], (T::kPingPong ? 128 : kGemmConsumers) / 32);
    }
    if (T::kPingPong) {
      mbar_init(&turn[0], 1);
      mbar_init(&turn[1], 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kGemmConsumers / 32) {  // the producer
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int mt = t / n_tiles;
        const int nt = t - mt * n_tiles;
        const int w = nt / n_per_w;
        const int col0 = (nt - w * n_per_w) * kBN;
        const CUtensorMap* tw = w == 0 ? tm_w0 : (w == 1 ? tm_w1 : tm_w2);
        for (int kb = 0; kb < k_steps; ++kb) {
          // A fresh barrier counts its preceding phase as complete.
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* a_s = smem + stage * kStageBytes;
          uint8_t* w_s = a_s + T::kABytes;
          mbar_arrive_expect_tx(&full[stage], kStageBytes);
          tma_load_2d(a_s, tm_a, &full[stage], kb * kBK, mt * kBM);
          for (int i = 0; i < kBN / 64; ++i) {
            tma_load_2d(w_s + i * kTileBytes, tw, &full[stage], col0 + 64 * i,
                        kb * kBK);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  uint8_t* my_out = out_s + wg * T::kOutBytes;
  int stage = 0;
  uint32_t phase = 0;
  // Moves the ring position past the other warpgroup's tile (ping-pong).
  auto skip_tile = [&]() {
    stage += k_steps;
    while (stage >= kStages) {
      stage -= kStages;
      phase ^= 1;
    }
  };
  if (T::kPingPong && wg == 1) skip_tile();
  const int first = T::kPingPong ? blockIdx.x + wg * gridDim.x : blockIdx.x;
  const int step = T::kPingPong ? 2 * gridDim.x : gridDim.x;
  float acc[kMB][kBN / 2];
  for (int t = first, j = 0; t < tiles; t += step, ++j) {
    const int mt = t / n_tiles;
    const int nt = t - mt * n_tiles;
    const int w = nt / n_per_w;
    const int col0 = (nt - w * n_per_w) * kBN;
    // Ping-pong: warpgroup 0's first tile needs no turn; every other tile
    // waits for the other warpgroup's arrival after its tile before.
    if (T::kPingPong && (wg == 1 || j > 0)) {
      mbar_wait(&turn[wg], (wg == 1 ? j : j - 1) & 1);
    }
    int prev = 0;
    for (int kb = 0; kb < k_steps; ++kb) {
      mbar_wait(&full[stage], phase);
      const uint8_t* a_s = smem + stage * kStageBytes;
      const uint8_t* w_s = a_s + T::kABytes;
      const uint64_t db = desc_mn_major_n128(w_s);
      wgmma_fence();
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb) {
        const uint64_t da = desc_k_major(
            a_s + (T::kPingPong ? mb : wg) * kTileBytes);
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks) {
          wgmma_ss_n128(acc[mb], da + ks * kKMajorStep,
                        db + ks * kMNMajorStep, kb > 0 || ks > 0);
        }
      }
      wgmma_commit();
      if (kb > 0) {  // the stage before is read: hand it back
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    // Every stage of this tile has arrived: the other warpgroup's turn.
    if (T::kPingPong && tid % 128 == 0) mbar_arrive(&turn[wg ^ 1]);
    wgmma_wait<0>();
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) fence(acc[mb]);
    if (lane == 0) mbar_arrive(&empty[prev]);

    // Bias and Epi in f32, one rounding, into the warpgroup's swizzled
    // output boxes once TMA has read the tile before out of them; then TMA
    // stores them (rows past m and columns past n are not written) while
    // the next tile's products run.
    const __nv_bfloat16* bias = w == 0 ? b0 : (w == 1 ? b1 : b2);
    const CUtensorMap* tc = w == 0 ? tm_c0 : (w == 1 ? tm_c1 : tm_c2);
    if (tid % 128 == 0) bulk_wait_read<0>();
    wg_barrier(wg);
    const int r = (warp & 3) * 16 + g;
#pragma unroll
    for (int j8 = 0; j8 < kBN / 8; ++j8) {
      const int col = col0 + 8 * j8 + 2 * t4;  // even, and n is too
      const float2 bxy =
          col < n ? __bfloat1622float2(
                        *reinterpret_cast<const __nv_bfloat162*>(bias + col))
                  : make_float2(0.f, 0.f);
      const float bx = bxy.x, by = bxy.y;
      const int c = (8 * j8 + 2 * t4) % 64;
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb) {
        uint8_t* box = my_out + (mb * (kBN / 64) + j8 / 8) * kTileBytes;
        st_swizzled(box, r, c, Epi::apply(acc[mb][4 * j8] + bx),
                    Epi::apply(acc[mb][4 * j8 + 1] + by));
        st_swizzled(box, r + 8, c, Epi::apply(acc[mb][4 * j8 + 2] + bx),
                    Epi::apply(acc[mb][4 * j8 + 3] + by));
      }
    }
    fence_proxy_async();
    wg_barrier(wg);
    if (tid % 128 == 0) {
      for (int mb = 0; mb < kMB; ++mb) {
        const int row0 = mt * kBM + (T::kPingPong ? mb : wg) * 64;
        for (int i = 0; i < kBN / 64 && col0 + 64 * i < n; ++i) {
          tma_store_2d(tc, my_out + (mb * (kBN / 64) + i) * kTileBytes,
                       col0 + 64 * i, row0);
        }
      }
      bulk_commit();
    }
    if (T::kPingPong) skip_tile();
  }
  if (tid % 128 == 0) bulk_wait<0>();
}

}  // namespace sm90

namespace sm90_host {

// Multiprocessors of the current device, read once a process.
inline int sm_count() {
  static const int count = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  return count;
}

// Tensor map over a row-major (rows, cols) bf16 matrix with `ld` elements
// a row, box of `box_rows` rows by 64 columns with the 128-byte swizzle.
// Rows and columns out of bounds arrive as zeros.
inline bool matrix_map(CUtensorMap* map, const void* base, int rows,
                       int cols, int ld, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90_host
