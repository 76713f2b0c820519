// The Hopper (sm_90a) max-shift attention core that K6's attention stage
// (fused_mha.cu), K7 (attention_unpacked.cu) and the seven arms of K9
// (attention_ablate.cu) run: per (head, batch row), with S = (Q K^T) *
// scale in f32,
//   S masked to -inf for keys past L;  m = rowmax(S);
//   p = bf16(exp(S - m) / rowsum(exp(S - m)));  O = bf16(f32(p V))
// the arithmetic of small_vision_tpu/ops/fused_block.py::_mha_kernel and
// ops/attention.py::_attn_kernel, and the arms that
// scripts/ablate_attention_kernel.py::_kernel_variant derives from it.
//
// Design (K3's structure, attention_packed.cu, with the exact softmax). A
// CTA takes one (head, batch row): the head's K and V blocks of 64 rows
// come by TMA through 4-D tensor maps over (D, heads, L, B) bounded at L
// (rows past it arrive as zeros) and stay resident; one or two warpgroups
// walk the query tiles, each from its own Q buffer. Pass 1 over the key
// blocks keeps a running max and a rescaled sum, computing block j + 1's S
// while it reads block j's; pass 2 recomputes S (the same products, the
// same bits), forms p with the final max and sum, rounds it and feeds it
// from registers to the P V product, issued with the next block's S. The
// head offsets of q, k and v in their maps and the output's row stride are
// arguments, so one kernel serves any packed layout (K6 reads q, k and v
// as heads 0..H-1, H..2H-1 and 2H..3H-1 of one (B, L, 3 H*D) scratch). Q
// stays in shared memory (wgmma's A from registers would cost 16 registers
// a thread, and at 128 a thread ptxas spilled and serialised the
// products). No atomics and no split-K: two launches give the same bits.
//
// Long heads: K and V stream. Past attn_resident_len (320 at D <= 64, 384
// to 128, 0 above) the kernel's kStream instantiation runs instead: grid
// (query-tile pairs, heads, batch), a CTA's two warpgroups one tile each,
// and the key blocks through a ring of attn_ring_stages K and V stages
// (sm90.cuh's Ring: a full and an empty mbarrier a stage; 5 stages of 16
// KB at one tile a head, two CTAs an SM, 6 of 32 KB at two). Every pass
// walks the key blocks again through the ring in the same order for both
// warpgroups: the passes before the last load K alone, the last K and V
// (nomm: V alone; nosoftmax has only the last). A stage is refilled once
// every consumer warp has released it, the ring kept attn_ring_stages - 2
// uses ahead of the one waited for (each wait first issues that use;
// every consumer thread runs the same straight code and thread 0 alone
// copies, predicated: a thread-dependent branch inside the wgmma pipeline
// made ptxas serialise the products). When the tiles are odd in number,
// the last CTA's second warpgroup recomputes the last tile and stores
// nothing: it releases the stages as the first does, and every warpgroup
// runs one tile (see attention_heads). p is still formed with the final
// max and sum of the row, then rounded: the function of _mha_kernel and
// _attn_kernel, which hold the whole row, not a one-pass online softmax
// that rescales O. So the streamed kernel gives the resident one's bits,
// and every length up to kAttnMaxLen (4,096, K4's and K8's) the plain
// version's function. A pair's CTAs are neighbours in the grid, so a
// head's K and V come from device memory about once and from L2 once a
// pass a pair.
//
// Head dims: any multiple of 8 up to 2,048, as K3 (attention_packed.cu);
// up to 256 a head is NT = ceil(D / 64) tiles of 64 columns (1 to 4),
// each a TMA box of the (D, heads, L, B) map, so columns at or past D
// arrive as zeros and a head never reads the next one's (past 256 too):
// the padded columns of Q and K add 0
// to the scores, those of V give 0 columns of O, which the store drops. At
// NT = 2 K, V and Q double in shared memory (L up to 384, not 832) and O's
// accumulator takes 32 more registers a thread (such a CTA may take up to
// 255); the scores, the exps and the passes are the same.
//
// Wide heads (NT = 3 and 4, D = 136 to 256) always stream: a resident head
// would hold 2 or 3 key blocks at most. A stage of K and V together would
// be 48 or 64 KB, and beside the two warpgroups' Q tiles (48 or 64 KB)
// only 3 or 2 such stages fit, which leaves the ring 1 or 0 loads ahead of
// the one waited for: no copy in flight during the products. So at NT >= 3
// a stage holds one head of K or of V (24 or 32 KB), and the last pass
// walks K_0, V_0, K_1, V_1, ... as separate ring uses (attn_split_kv): 7
// stages at NT = 3, 5 at NT = 4, the ring 5 or 3 uses (2.5 or 1.5 blocks)
// ahead. The passes before it read K alone, one use a block, as before. A
// warp holds at most the use it waits for and the one before (V_j, whose P
// V product is in flight, while it waits for K_{j+1}), as the ring needs.
// O's accumulator is 96 or 128 registers a thread beside S (32) and p
// (16): one CTA of two warpgroups an SM, up to 255 registers a thread. The
// arithmetic and the order of every sum are NT = 2's, with more products.
//
// Heads past four tiles (D = 264 to 2,048: `heads=2` at width 768 is 384,
// `heads=1` 768; a ViT-G head alone 1,664) run attention_wide, once for
// every policy here and for K3's (ClampExp2). A head no longer fits: one
// 64-row tile of Q or of K is 96 KB at D = 768 and 256 KB at 2,048. So the
// two sides of the head part:
//  - the contraction: S = Q K^T is summed over the nd = ceil(D / 64)
//    column tiles in a loop of run-time length, tile c of Q's query tile
//    and of K's key block arriving together as one 16 KB stage of the pair
//    ring (sm90.cuh: 6 stages, 4 loads ahead, Ring's predicated copies),
//    one commit group a tile, so that at most two stages are held;
//  - the output: O's columns are split across CTAs, kWideTiles = 4 tiles
//    (256 columns, 128 accumulator registers, NT = 4's) a CTA. The grid is
//    (chunks x query tiles, heads, batch), a tile's chunks neighbours, so
//    the re-read Q and K come from L2; V's block j comes as two uses of
//    two of the chunk's column tiles.
// Every chunk of a query tile computes the same S, the same max, sums and
// rescales in the same order, so its columns are the whole head's, bit
// for bit, whatever the chunk count (the `_chunked` entry points store
// fewer tiles a CTA to show it); no atomics, no sum across CTAs. The
// cost: each chunk recomputes S and its softmax, every pass (2 chunks at
// D = 384, 3 at 768, 8 at 2,048), and Q is read again for every key
// block. Shared memory is 97 KB a CTA at every D (two CTAs an SM);
// registers: O 128, S 32, p 16 a thread, under the 255 of two 128-thread
// CTAs an SM (ptxas's report: the build log). Weighed: Q resident beside
// a ring of K (fits to D = 768 at one CTA an SM, not past it: a second
// design for part of the range); two warpgroups of a CTA on two query
// tiles sharing K and V (halves the reads of K and V, but a stage of two
// Q tiles and K is 24 KB and V's 32 KB, and one CTA an SM). The first
// design is the simplest that takes every D; making it fast is later work.
//
// A compile-time softmax policy says how S is scaled and masked, how e is
// formed, how many passes run and whether the products run at all.
// `SoftmaxExp2` is the production one (K6, K7, K9's exp2 arm); the others
// are K9's arms, each one change from it, so that the ablation tool splits
// the cost of the core the model runs.

#pragma once

#include <math_constants.h>

#include <type_traits>

#include "sm90_gemm.cuh"

namespace sm90 {

constexpr int kAttnShortTiles = 3;  // one warpgroup for heads this short
constexpr int kAttnMaxHeadDim = 2048;
constexpr int kAttnMaxLen = 4096;  // every head dim; K4's and K8's limit
constexpr int kSmemPerBlock = 232448;
constexpr int kSmemPerSM = 233472;  // blocks an SM holds: 1 KB each reserved

// 64-column tiles a head of `head_dim` columns takes.
__host__ __device__ constexpr int attn_tiles(int head_dim) {
  return (head_dim + 63) / 64;
}

// Whether a ring stage holds one head of K or of V (NT >= 3), not both.
__host__ __device__ constexpr bool attn_split_kv(int nt) { return nt > 2; }

// 1 KB to align the tiles; `stages` K and `stages` V blocks (split: `stages`
// blocks of either) and one Q tile a warpgroup, each of nt 64-column tiles;
// barriers: two a stage (resident: a K and a V block's; streamed: the
// ring's full and empty), one a Q tile.
__host__ __device__ constexpr size_t attn_smem_bytes(int stages, int groups,
                                                     int nt) {
  return 1024 +
         static_cast<size_t>((attn_split_kv(nt) ? 1 : 2) * stages + groups) *
             nt * kTileBytes +
         8 * static_cast<size_t>(2 * stages + groups);
}

// Stages of the streamed ring: two CTAs an SM at one tile a head, one at
// two or more (the kernels' launch bounds); at three and four as many
// single K or V blocks as fit beside the two Q tiles.
__host__ __device__ constexpr int attn_ring_stages(int nt) {
  return nt == 1 ? 5 : nt == 2 ? 6 : nt == 3 ? 7 : 5;
}
static_assert(2 * (attn_smem_bytes(attn_ring_stages(1), 2, 1) + 1024) <=
                  kSmemPerSM,
              "two streamed CTAs an SM at one tile a head");
static_assert(attn_smem_bytes(attn_ring_stages(2), 2, 2) <= kSmemPerBlock,
              "one streamed CTA an SM at two tiles a head");
static_assert(attn_smem_bytes(attn_ring_stages(3), 2, 3) <= kSmemPerBlock &&
                  attn_smem_bytes(attn_ring_stages(3) + 1, 2, 3) >
                      kSmemPerBlock,
              "one streamed CTA an SM at three tiles a head, the most stages");
static_assert(attn_smem_bytes(attn_ring_stages(4), 2, 4) <= kSmemPerBlock &&
                  attn_smem_bytes(attn_ring_stages(4) + 1, 2, 4) >
                      kSmemPerBlock,
              "one streamed CTA an SM at four tiles a head, the most stages");

// Longest sequence whose K and V stay resident at a head dim: while its
// CTA fits an SM as often as the streamed one (two at one tile a head, L
// <= 320; one at two, L <= 384). Resident heads fit up to 832 at D <= 64,
// but past 320 one CTA an SM, and read slower than streamed (PERF.md);
// longer ones stream through the ring. 0 at three or four tiles a head:
// every length streams.
__host__ __device__ constexpr int attn_resident_len(int head_dim) {
  const int nt = attn_tiles(head_dim);
  if (attn_split_kv(nt)) return 0;
  const int ctas = nt == 1 ? 2 : 1;
  int nkb = 1;
  while (ctas * (attn_smem_bytes(nkb + 1, 2, nt) + 1024) <= kSmemPerSM) {
    ++nkb;
  }
  return nkb * kTileRows;
}

// Longest sequence the core takes: kAttnMaxLen at every head dim.
__host__ __device__ constexpr int attn_max_len(int) { return kAttnMaxLen; }

// A launch's scalars: head h's q, k, v are heads q_head + h, k_head + h,
// v_head + h of their (D, heads, L, B) maps, and its output the D columns
// at h D of o, o_ld elements a row. `scale` is the policy's (see
// launch_attention).
struct AttnArgs {
  int q_head, k_head, v_head;
  __nv_bfloat16* o;
  int o_ld;
  int seq_len;
  int head_dim;
  float scale;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Element (r, c) of a 64 x 64 bf16 tile in TMA's 128-byte swizzle.
__device__ __forceinline__ float ld_swizzled(const uint8_t* tile, int r,
                                             int c) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
      tile + r * 128 + (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2));
}

// wgmma_wait<kPending> where products were issued.
template <bool kProducts, int kPending>
__device__ __forceinline__ void wgmma_wait_if() {
  if constexpr (kProducts) wgmma_wait<kPending>();
}

// ---- softmax policies ----------------------------------------------------
//
// kPasses: the passes over the keys before the last one, which forms p.
// kProducts: false for nomm (no QK product, no P V product). kBase2: the
// launcher folds log2(e) into the scale. score(): S of one key from its
// raw product, entering the max and the sum; exp(): the base's
// exponential, which rescales the running sum; e(): one key's e given the
// row's shift; p(): one key's probability from its raw product, the final
// shift and 1 / sum, before its rounding to bf16.
enum class Passes {
  kNone,    // p from S alone
  kOnline,  // one pass: a running max and a sum rescaled as it grows
  kSum,     // one pass: the sum of unshifted e
  kMaxSum,  // the max, then the sum with the final max
};

// The production softmax: S * scale * log2(e) with keys past L at -inf,
// e = 2^(S - m) by ex2.
struct SoftmaxExp2 {
  static constexpr Passes kPasses = Passes::kOnline;
  static constexpr bool kProducts = true, kBase2 = true;
  __device__ static float score(float s, int key, int len, float scale) {
    return key < len ? s * scale : -CUDART_INF_F;
  }
  __device__ static float exp(float x) { return exp2_ftz(x); }
  __device__ static float e(float x, float m, int, int) {
    return exp2_ftz(x - m);
  }
  __device__ static float p(float s, int key, int len, float scale, float m,
                            float inv) {
    return key < len ? exp2_ftz(s * scale - m) * inv : 0.f;
  }
};

// prod: the same in the natural base, e = expf(S * scale - m) (the JAX
// arm's jnp.exp).
struct SoftmaxExp {
  static constexpr Passes kPasses = Passes::kOnline;
  static constexpr bool kProducts = true, kBase2 = false;
  __device__ static float score(float s, int key, int len, float scale) {
    return key < len ? s * scale : -CUDART_INF_F;
  }
  __device__ static float exp(float x) { return expf(x); }
  __device__ static float e(float x, float m, int, int) {
    return expf(x - m);
  }
  __device__ static float p(float s, int key, int len, float scale, float m,
                            float inv) {
    return key < len ? expf(s * scale - m) * inv : 0.f;
  }
};

// nosoftmax: one pass, p = bf16(S * scale * 0.001), no mask (keys past L
// are zero rows, so their p and their V rows are 0).
struct NoSoftmax : SoftmaxExp {
  static constexpr Passes kPasses = Passes::kNone;
  __device__ static float p(float s, int, int, float scale, float, float) {
    return s * scale * 0.001f;
  }
};

// nomm: no products; every score of row i is f32(bf16(q[i][0] * scale))
// (the kernel fills S with it, scaled already), then prod's softmax with
// all its passes and every exp; out[i][:] = bf16(p[i][0] * v[i][0]).
struct NoMatmul : SoftmaxExp {
  static constexpr bool kProducts = false;
  __device__ static float score(float s, int key, int len, float) {
    return key < len ? s : -CUDART_INF_F;
  }
  __device__ static float p(float s, int key, int len, float, float m,
                            float inv) {
    return key < len ? expf(s - m) * inv : 0.f;
  }
};

// bf16exp: e = bf16(expf(bf16(S - m))), summed in f32. The rounding needs
// the final max, so the max and the sum take a pass each, and the sum is
// the sum of the very e that are normalised.
struct Bf16Exp : SoftmaxExp {
  static constexpr Passes kPasses = Passes::kMaxSum;
  __device__ static float e(float x, float m, int, int) {
    return round_bf16(expf(round_bf16(x - m)));
  }
  __device__ static float p(float s, int key, int len, float scale, float m,
                            float inv) {
    return e(score(s, key, len, scale), m, key, len) * inv;
  }
};

// mulmask: the max over the first lp = L rounded up to 16 columns (the TPU
// tile's; its keys past L score exactly 0), not over the 64-row TMA tile,
// whose further zero keys the JAX arm never sees; e = expf(S - m) [key < L],
// the mask a multiply after exp.
struct MulMask : SoftmaxExp {
  __device__ static float score(float s, int key, int len, float scale) {
    return key < ((len + 15) & ~15) ? s * scale : -CUDART_INF_F;
  }
  __device__ static float e(float x, float m, int key, int len) {
    return expf(x - m) * (key < len ? 1.f : 0.f);
  }
  __device__ static float p(float s, int key, int len, float scale, float m,
                            float inv) {
    return e(score(s, key, len, scale), m, key, len) * inv;
  }
};

// nomax: no shift, e = expf(S) [key < L] (numerically unsafe by design).
struct NoMax : SoftmaxExp {
  static constexpr Passes kPasses = Passes::kSum;
  __device__ static float score(float s, int, int, float scale) {
    return s * scale;
  }
  __device__ static float e(float x, float, int key, int len) {
    return expf(x) * (key < len ? 1.f : 0.f);
  }
  __device__ static float p(float s, int key, int len, float scale, float,
                            float inv) {
    return e(s * scale, 0.f, key, len) * inv;
  }
};

// ---- the core ------------------------------------------------------------

// Passes over the key blocks that read the ring (streamed): each reads K,
// the last one V too; nomm reads V alone, in its last pass. (At three or
// four tiles a head the last pass's K and V are two uses a block.)
template <class P>
__host__ __device__ constexpr int attn_ring_passes() {
  if constexpr (!P::kProducts || P::kPasses == Passes::kNone) {
    return 1;
  } else if constexpr (P::kPasses == Passes::kMaxSum) {
    return 3;
  } else {
    return 2;
  }
}

// The body of a kernel of 128 * kGroups threads: three maps over (D, heads,
// L, B) (sm90_host::packed_head_map_d); a head is NT 64-column tiles.
// Resident (kStream false): grid (heads, batch), a CTA walks all of its
// head's query tiles, its K and V blocks loaded once. Streamed (two
// warpgroups): grid (query-tile pairs, heads, batch), a CTA walks the
// pair's two tiles, one a warpgroup, through a ring of K and V stages. At
// NT >= 3 streamed only, a stage one head of K or of V (attn_split_kv).
template <class P, int kGroups, int NT, bool kStream>
__device__ __forceinline__ void attention_heads(uint8_t* smem_raw,
                                                const CUtensorMap* tm_q,
                                                const CUtensorMap* tm_k,
                                                const CUtensorMap* tm_v,
                                                const AttnArgs& a) {
  constexpr int kHeadBytes = NT * kTileBytes;
  constexpr int kRing = attn_ring_stages(NT);
  constexpr int kRingPasses = attn_ring_passes<P>();
  // One array of single-operand stages; kSplit: the last pass's K and V
  // of a block are two ring uses (nomm's last pass reads V alone anyway).
  constexpr bool kOneBuf = attn_split_kv(NT);
  constexpr bool kSplit = kOneBuf && P::kProducts;
  static_assert(kStream || !kOneBuf, "three or four tiles a head stream");
  uint8_t* smem = align_tiles(smem_raw);
  const int seq_len = a.seq_len;
  const float scale = a.scale;
  const int nkb = (seq_len + kTileRows - 1) / kTileRows;
  const int nqt = nkb;
  // Resident: stage j holds key block j's K and V for every pass, each
  // with its barrier. Streamed: ring use n = r * nkb + j (pass r's block
  // j, r counting the passes that read the ring) lands in stage n % kRing,
  // its K and V (what the pass reads) under one full barrier; the second
  // row of barriers is the ring's empty ones. kSplit: the last pass's
  // uses are n_last + 2 j (K_j) and n_last + 2 j + 1 (V_j), each a stage.
  const int stages = kStream ? kRing : nkb;
  uint8_t* k_s = smem;  // stage s at s * NT * 8 KB
  uint8_t* v_s = kOneBuf ? k_s : k_s + stages * kHeadBytes;
  uint8_t* q_s = v_s + stages * kHeadBytes;  // warpgroup w's at w * NT * 8 KB
  uint64_t* k_full = reinterpret_cast<uint64_t*>(q_s + kGroups * kHeadBytes);
  uint64_t* v_full = k_full + stages;
  uint64_t* q_full = v_full + stages;
  const Ring<kRing> ring{k_full, v_full};  // streamed only

  const int head = kStream ? blockIdx.y : blockIdx.x;
  const int batch = kStream ? blockIdx.z : blockIdx.y;
  // Streamed: the ring's loads.
  const int total = (kSplit ? kRingPasses + 1 : kRingPasses) * nkb;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // Resident: warpgroup w walks tiles w, w + kGroups, ... Streamed: tile
  // kGroups x + w, exactly one, so that every warpgroup runs the same
  // count of products (a trip count that differs between the warpgroups
  // made ptxas serialise the streamed kernels' products and spill): when
  // the tiles are odd in number, the last CTA's second warpgroup
  // recomputes the last tile, releases the ring's stages as the first
  // does, and stores nothing.
  const int t_mine =
      kStream ? min(blockIdx.x * kGroups + warp / 4, nqt - 1) : warp / 4;
  const bool dummy = kStream && blockIdx.x * kGroups + warp / 4 >= nqt;

  // Head `h` of a map's NT tiles of 64 rows from `row` into dst (zeros
  // past D and L).
  auto load_head = [&](uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                       int h, int row) {
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      tma_load_4d(dst + c * kTileBytes, map, bar, c * 64, h, row, batch);
    }
  };
  // Ring load n into stage s: its block's K (with products) and, in the
  // last pass, its V. Every consumer thread calls it; thread 0 alone
  // copies (predicated, no branch: see Ring).
  auto ring_load = [&](int n, int s, uint64_t* bar, bool issue) {
    const int r = (n >= nkb) + (kRingPasses > 2 && n >= 2 * nkb);
    const bool leader = issue && tid == 0;
    if constexpr (kSplit) {
      // Before the last pass K of block n - r nkb; in it, K or V of block
      // (n - n_last) / 2 by the parity.
      const int m = n - (kRingPasses - 1) * nkb;
      const bool is_v = m >= 0 && (m & 1);
      const int row = (m >= 0 ? m >> 1 : n - r * nkb) * kTileRows;
      mbar_arrive_expect_tx_if(bar, kHeadBytes, leader);
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        tma_load_4d_if(k_s + s * kHeadBytes + c * kTileBytes,
                       is_v ? tm_v : tm_k, bar, c * 64,
                       (is_v ? a.v_head : a.k_head) + head, row, batch,
                       leader);
      }
      return;
    }
    const int row = (n - r * nkb) * kTileRows;
    const bool with_v = r == kRingPasses - 1;
    mbar_arrive_expect_tx_if(
        bar, ((P::kProducts ? 1 : 0) + (with_v ? 1 : 0)) * kHeadBytes,
        leader);
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      if constexpr (P::kProducts) {
        tma_load_4d_if(k_s + s * kHeadBytes + c * kTileBytes, tm_k, bar,
                       c * 64, a.k_head + head, row, batch, leader);
      }
      tma_load_4d_if(v_s + s * kHeadBytes + c * kTileBytes, tm_v, bar,
                     c * 64, a.v_head + head, row, batch, leader && with_v);
    }
  };
  if (tid == 0) {
    if constexpr (kStream) {
      ring.init(4 * kGroups);
      for (int w = 0; w < kGroups; ++w) mbar_init(&q_full[w], 1);
    } else {
      for (int j = 0; j < 2 * nkb + kGroups; ++j) mbar_init(&k_full[j], 1);
    }
    fence_barrier_init();
    // The first Q tiles, the K blocks (pass 1 needs them first), then V.
    for (int w = 0; w < kGroups && (kStream || w < nqt); ++w) {
      const int t = kStream ? min(blockIdx.x * kGroups + w, nqt - 1) : w;
      mbar_arrive_expect_tx(&q_full[w], kHeadBytes);
      load_head(q_s + w * kHeadBytes, tm_q, &q_full[w], a.q_head + head,
                t * kTileRows);
    }
    if constexpr (kStream) {
      ring.prime(total, ring_load);
    } else {
      if constexpr (P::kProducts) {
        for (int j = 0; j < nkb; ++j) {
          mbar_arrive_expect_tx(&k_full[j], kHeadBytes);
          load_head(k_s + j * kHeadBytes, tm_k, &k_full[j], a.k_head + head,
                    j * kTileRows);
        }
      }
      for (int j = 0; j < nkb; ++j) {
        mbar_arrive_expect_tx(&v_full[j], kHeadBytes);
        load_head(v_s + j * kHeadBytes, tm_v, &v_full[j], a.v_head + head,
                  j * kTileRows);
      }
    }
  }
  __syncthreads();

  const int wg = warp / 4;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int row = (warp % 4) * 16 + g;  // this thread's rows: row, row + 8
  __nv_bfloat16* out = a.o + static_cast<size_t>(batch) * seq_len * a.o_ld +
                       static_cast<size_t>(head) * a.head_dim;
  uint8_t* my_q = q_s + wg * kHeadBytes;
  const uint64_t d_q = desc_k_major(my_q);

  // Use n's K and V tiles (resident: n is the key block).
  auto k_tile = [&](int n) {
    return k_s + (kStream ? ring.stage(n) : n) * kHeadBytes;
  };
  auto v_tile = [&](int n) {
    return v_s + (kStream ? ring.stage(n) : n) * kHeadBytes;
  };
  // Streamed: the ring's wait for use n (which first issues use n +
  // kAhead).
  auto wait_stage = [&](int n) { ring.wait(n, total, ring_load); };
  auto wait_k = [&](int n) {
    if constexpr (kStream) {
      wait_stage(n);
    } else {
      mbar_wait(&k_full[n], 0);
    }
  };
  // Streamed, V comes with K (waited for there), or alone (nomm; kSplit).
  auto wait_v = [&](int n) {
    if constexpr (!kStream) {
      mbar_wait(&v_full[n], 0);
    } else if constexpr (!P::kProducts || kSplit) {
      wait_stage(n);
    }
  };
  // This warp is done with use n's stage.
  auto release = [&](int n) {
    if constexpr (kStream) ring.release(n, lane);
  };
  // Ring uses a pass (0 resident: every pass reads the same stages).
  const int pass_uses = kStream ? nkb : 0;
  const int n_last = (kRingPasses - 1) * pass_uses;
  // The last pass's uses of block j's K and V.
  auto k_use = [&](int j) { return kSplit ? n_last + 2 * j : n_last + j; };
  auto v_use = [&](int j) {
    return kSplit ? n_last + 2 * j + 1 : n_last + j;
  };

  for (int t = t_mine, use = 0; kStream ? use < 1 : t < nqt;
       t += kGroups, ++use) {
    mbar_wait(&q_full[wg], use & 1);

    // S of ring use n into s: the QK product over the head's NT tiles, or
    // nomm's row constants.
    float c_lo = 0.f, c_hi = 0.f;
    if constexpr (!P::kProducts) {
      c_lo = round_bf16(ld_swizzled(my_q, row, 0) * scale);
      c_hi = round_bf16(ld_swizzled(my_q, row + 8, 0) * scale);
    }
    // Tile c's descriptor is tile 0's plus c * 8 KB in the 16-byte units of
    // its address field. (An array of per-tile descriptors made the
    // one-tile kernels spill at their 128 registers and cost K7 4 % at the
    // sampler's shape.)
    auto products_s = [&](float (&s)[32], int n) {
      const uint64_t d_k = desc_k_major(k_tile(n));
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        gemm_nt(s, d_q + c * (kTileBytes >> 4), d_k + c * (kTileBytes >> 4),
                c > 0);
      }
    };
    auto issue_s = [&](float (&s)[32], int n) {
      if constexpr (P::kProducts) {
        wait_k(n);
        wgmma_fence();
        products_s(s, n);
        wgmma_commit();
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float x = (i & 2) ? c_hi : c_lo;
          // Opaque to the compiler, so that the softmax of every key stays
          // although the scores of a row are all equal.
          asm volatile("" : "+f"(x));
          s[i] = x;
        }
      }
    };
    // Calls fn(s, j) on every key block's S in order (ring uses n0 + j),
    // computing block j + 1's S while block j's is read; a block's stage
    // is released once its product is done.
    auto walk = [&](int n0, auto&& fn) {
      float s0[32], s1[32];
      issue_s(s0, n0);
      for (int j = 0; j < nkb; j += 2) {
        if (j + 1 < nkb) {
          issue_s(s1, n0 + j + 1);
          wgmma_wait_if<P::kProducts, 1>();
        } else {
          wgmma_wait_if<P::kProducts, 0>();
        }
        fence(s0);
        if constexpr (P::kProducts) release(n0 + j);
        fn(s0, j);
        if (j + 1 < nkb) {
          if (j + 2 < nkb) {
            issue_s(s0, n0 + j + 2);
            wgmma_wait_if<P::kProducts, 1>();
          } else {
            wgmma_wait_if<P::kProducts, 0>();
          }
          fence(s1);
          if constexpr (P::kProducts) release(n0 + j + 1);
          fn(s1, j + 1);
        }
      }
    };

    // This lane's scores of rows g and g + 8 (lo, hi) over its 16 keys of
    // block j, in place; the block's max of each row.
    auto scores = [&](float (&s)[32], int j, float& b_lo, float& b_hi) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = j * kTileRows + nt * 8 + 2 * t4 + (i & 1);
          const float x = P::score(s[4 * nt + i], key, seq_len, scale);
          s[4 * nt + i] = x;
          if (i < 2) {
            b_lo = fmaxf(b_lo, x);
          } else {
            b_hi = fmaxf(b_hi, x);
          }
        }
      }
    };
    // The sum of e over this lane's keys of block j, row lo (i0 = 0) or
    // hi (i0 = 2), with shift m.
    auto block_sum = [&](const float (&s)[32], int j, int i0, float m) {
      float e = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int key = j * kTileRows + nt * 8 + 2 * t4;
        e += P::e(s[4 * nt + i0], m, key, seq_len) +
             P::e(s[4 * nt + i0 + 1], m, key + 1, seq_len);
      }
      return e;
    };

    float row_m_lo = 0.f, row_m_hi = 0.f, inv_lo = 1.f, inv_hi = 1.f;
    if constexpr (P::kPasses == Passes::kOnline) {
      // Pass 1: this lane's running max and rescaled sum.
      float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F, l_lo = 0.f,
            l_hi = 0.f;
      walk(0, [&](float (&s)[32], int j) {
        float b_lo = -CUDART_INF_F, b_hi = -CUDART_INF_F;
        scores(s, j, b_lo, b_hi);
        const float n_lo = fmaxf(m_lo, b_lo);
        const float n_hi = fmaxf(m_hi, b_hi);
        if (n_lo > -CUDART_INF_F) {  // else every key so far is masked
          l_lo = l_lo * P::exp(m_lo - n_lo) + block_sum(s, j, 0, n_lo);
          m_lo = n_lo;
        }
        if (n_hi > -CUDART_INF_F) {
          l_hi = l_hi * P::exp(m_hi - n_hi) + block_sum(s, j, 2, n_hi);
          m_hi = n_hi;
        }
      });
      // Merge the four lanes of a row (a lane that saw no key has l = 0).
      row_m_lo = quad_max(m_lo);
      row_m_hi = quad_max(m_hi);
      inv_lo = 1.f / quad_sum(l_lo * P::exp(m_lo - row_m_lo));
      inv_hi = 1.f / quad_sum(l_hi * P::exp(m_hi - row_m_hi));
    } else if constexpr (P::kPasses == Passes::kSum) {
      // Pass 1: the unshifted sum.
      float l_lo = 0.f, l_hi = 0.f;
      walk(0, [&](float (&s)[32], int j) {
        float b_lo = -CUDART_INF_F, b_hi = -CUDART_INF_F;
        scores(s, j, b_lo, b_hi);
        l_lo += block_sum(s, j, 0, 0.f);
        l_hi += block_sum(s, j, 2, 0.f);
      });
      inv_lo = 1.f / quad_sum(l_lo);
      inv_hi = 1.f / quad_sum(l_hi);
    } else if constexpr (P::kPasses == Passes::kMaxSum) {
      // Pass 1: the max; pass 2: the sum with it.
      float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F;
      walk(0, [&](float (&s)[32], int j) { scores(s, j, m_lo, m_hi); });
      row_m_lo = quad_max(m_lo);
      row_m_hi = quad_max(m_hi);
      float l_lo = 0.f, l_hi = 0.f;
      walk(pass_uses, [&](float (&s)[32], int j) {
        float b_lo = -CUDART_INF_F, b_hi = -CUDART_INF_F;
        scores(s, j, b_lo, b_hi);
        l_lo += block_sum(s, j, 0, row_m_lo);
        l_hi += block_sum(s, j, 2, row_m_hi);
      });
      inv_lo = 1.f / quad_sum(l_lo);
      inv_hi = 1.f / quad_sum(l_hi);
    }

    // Last pass: S again, p formed with the final max and sum and rounded,
    // O += p V over the head's NT tiles of V; block j + 1's S is issued
    // with block j's P V product.
    float sacc[32], oacc[NT][32];
    uint32_t pa[16];
    float p0_lo = 0.f, p0_hi = 0.f;  // nomm: p of key 0
    float v0_lo = 0.f, v0_hi = 0.f;  // nomm: the row's own v[0]
    issue_s(sacc, k_use(0));
    wgmma_wait_if<P::kProducts, 0>();
    fence(sacc);
    if constexpr (kSplit) release(k_use(0));
    for (int j = 0; j < nkb; ++j) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = j * kTileRows + nt * 8 + 2 * t4 + (i & 1);
          const float rm = i < 2 ? row_m_lo : row_m_hi;
          const float inv = i < 2 ? inv_lo : inv_hi;
          sacc[4 * nt + i] =
              P::p(sacc[4 * nt + i], key, seq_len, scale, rm, inv);
        }
      }
      pack_a(pa, sacc);
      if constexpr (P::kProducts) {
        wait_v(v_use(j));
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < NT; ++c) {
          gemm_rn(oacc[c], pa,
                  desc_mn_major(v_tile(v_use(j)) + c * kTileBytes), j > 0);
        }
        if (j + 1 < nkb) {
          wait_k(k_use(j + 1));
          products_s(sacc, k_use(j + 1));
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < NT; ++c) fence(oacc[c]);
        fence(sacc);
        release(v_use(j));
        // kSplit: block j + 1's K too, its S product done (predicated: a
        // branch here made ptxas serialise the products of two of K9's
        // arms, C7520).
        if constexpr (kSplit) ring.release_if(k_use(j + 1), lane, j + 1 < nkb);
      } else {
        if (j == 0) {
          p0_lo = sacc[0];
          p0_hi = sacc[2];
        }
        // The rounded p stay live as they would as the product's operand.
#pragma unroll
        for (int i = 0; i < 16; ++i) asm volatile("" ::"r"(pa[i]));
        // Row i's own v is row i of V block t. Streamed, every block's
        // stage is waited for and released in turn.
        if (kStream || j == t) wait_v(n_last + j);
        if (j == t) {
          v0_lo = ld_swizzled(v_tile(n_last + j), row, 0);
          v0_hi = ld_swizzled(v_tile(n_last + j), row + 8, 0);
        }
        if constexpr (kStream) {
          __syncwarp();
          release(n_last + j);
        }
        if (j + 1 < nkb) issue_s(sacc, n_last + j + 1);
      }
    }
    if constexpr (!P::kProducts) {
      // bf16(p[i][0]) v[i][0], a product of two bf16 (exact in f32) that
      // the store rounds once, on every column. Key 0 is held by the lanes
      // with t4 = 0.
      const int src = lane & ~3;
      const float pl = __shfl_sync(0xffffffffu, round_bf16(p0_lo), src);
      const float ph = __shfl_sync(0xffffffffu, round_bf16(p0_hi), src);
      const float o_lo = pl * v0_lo;
      const float o_hi = ph * v0_hi;
#pragma unroll
      for (int c = 0; c < NT; ++c) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          oacc[c][4 * n] = oacc[c][4 * n + 1] = o_lo;
          oacc[c][4 * n + 2] = oacc[c][4 * n + 3] = o_hi;
        }
      }
    }

    // The tile's products are done: its Q buffer takes the warpgroup's
    // next tile while this one is stored.
    if (!kStream && t + kGroups < nqt) {
      wg_barrier(wg);
      if (tid % 128 == 0) {
        mbar_arrive_expect_tx(&q_full[wg], kHeadBytes);
        load_head(my_q, tm_q, &q_full[wg], a.q_head + head,
                  (t + kGroups) * kTileRows);
      }
    }
    // Columns at or past D are dropped.
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      store_acc(out + c * 64, a.o_ld, t * kTileRows + row,
                dummy ? 0 : seq_len, oacc[c], 1.f, 1.f, t4,
                a.head_dim - c * 64);
    }
  }
}

// ---- wide heads (D > 256) -------------------------------------------------

// K3's softmax (attention_packed.cu) as a policy of the wide core: e =
// exp2(clamp(S * scale, -80, 80)) for keys below L, 0 past (`scale` is
// scale * log2(e), folded by K3's caller), no max and one pass; O =
// bf16(e) V divided at the store by the row sum of the unrounded e.
struct ClampExp2 {
  static constexpr Passes kPasses = Passes::kNone;
  static constexpr bool kProducts = true, kBase2 = false;
  __device__ static float p(float s, int key, int len, float scale, float,
                            float) {
    return key < len ? exp2f(fminf(fmaxf(s * scale, -80.f), 80.f)) : 0.f;
  }
};

// The passes over the keys before the last one, each reading K alone.
template <class P>
__host__ __device__ constexpr int wide_s_passes() {
  return P::kPasses == Passes::kNone     ? 0
         : P::kPasses == Passes::kMaxSum ? 2
                                         : 1;
}

// This lane's scores of rows g and g + 8 over its 16 keys of block j, in
// place, and their max of each row (attention_heads' `scores`).
template <class P>
__device__ __forceinline__ void wide_scores(float (&s)[32], int j, int len,
                                            float scale, int t4, float& b_lo,
                                            float& b_hi) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = j * kTileRows + nt * 8 + 2 * t4 + (i & 1);
      const float x = P::score(s[4 * nt + i], key, len, scale);
      s[4 * nt + i] = x;
      if (i < 2) {
        b_lo = fmaxf(b_lo, x);
      } else {
        b_hi = fmaxf(b_hi, x);
      }
    }
  }
}

// The sum of e over this lane's keys of block j, row lo (i0 = 0) or hi (i0
// = 2), with shift m (attention_heads' `block_sum`).
template <class P>
__device__ __forceinline__ float wide_block_sum(const float (&s)[32], int j,
                                                int i0, float m, int len,
                                                int t4) {
  float e = 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int key = j * kTileRows + nt * 8 + 2 * t4;
    e += P::e(s[4 * nt + i0], m, key, len) +
         P::e(s[4 * nt + i0 + 1], m, key + 1, len);
  }
  return e;
}

// The body of a wide-head kernel of 128 threads (see the header's "Wide
// heads"): grid (chunks x query tiles, heads, batch), chunk fastest; the
// CTA computes query tile t's S over all nd column tiles of the head,
// every pass, and O's column tiles tile0 .. tile0 + chunk_tiles - 1 (at
// most kWideTiles). Every operand streams through the pair ring.
constexpr int kWideTiles = 4;

template <class P>
__device__ __forceinline__ void attention_wide(uint8_t* smem_raw,
                                               const CUtensorMap* tm_q,
                                               const CUtensorMap* tm_k,
                                               const CUtensorMap* tm_v,
                                               const AttnArgs& a,
                                               int chunk_tiles) {
  constexpr bool kDivide = std::is_same<P, ClampExp2>::value;
  constexpr int kSPasses = wide_s_passes<P>();
  uint8_t* smem = align_tiles(smem_raw);
  const PairRing ring = pair_ring(smem);
  const int seq_len = a.seq_len;
  const float scale = a.scale;
  const int nkb = (seq_len + kTileRows - 1) / kTileRows;
  const int nd = attn_tiles(a.head_dim);
  const int nch = (nd + chunk_tiles - 1) / chunk_tiles;
  const int t = blockIdx.x / nch;
  const int tile0 = (blockIdx.x % nch) * chunk_tiles;
  const int tile_end = tile0 + chunk_tiles;  // past the CTA's O tiles
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // Ring uses: each S-only pass takes nd a key block (tile c of Q's tile t
  // and of K's block j); the last pass a block's nd pairs and then two
  // uses of V's block j (its column tiles tile0 .. tile0 + 3, two a use,
  // those the CTA does not store not copied). nomm: one use a block, Q's
  // tile 0 (row constants) and V's block j tile 0 (its own v).
  const int s_uses = P::kProducts ? nd : 0;
  const int per_last = P::kProducts ? nd + 2 : 1;
  const int n_last = kSPasses * nkb * s_uses;
  const int total = n_last + nkb * per_last;
  // Straight code for every thread (selects, no branch: see Ring).
  auto load = [&](int n, int s, uint64_t* bar, bool issue) {
    const bool before = n < n_last;
    const int m = before ? n % (nkb * nd) : n - n_last;
    const int per = before ? nd : per_last;
    const int j = m / per;
    const int u = m % per;
    const bool pair = P::kProducts && u < nd;
    const int cv = tile0 + 2 * (u - nd);  // V's first tile of the use
    const int ca = !P::kProducts ? 0 : pair ? u : cv < tile_end ? cv : nd;
    const int cb = !P::kProducts ? 0
                   : pair        ? u
                   : cv + 1 < tile_end ? cv + 1
                                       : nd;
    pair_load(smem + s * kPairBytes, bar, pair || !P::kProducts ? tm_q : tm_v,
              ca, (pair || !P::kProducts ? a.q_head : a.v_head) + head,
              pair || !P::kProducts ? t * kTileRows : j * kTileRows,
              pair ? tm_k : tm_v, cb, (pair ? a.k_head : a.v_head) + head,
              j * kTileRows, batch, nd, issue && tid == 0);
  };
  if (tid == 0) {
    ring.init(4);
    fence_barrier_init();
    ring.prime(total, load);
  }
  __syncthreads();

  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int row = (warp % 4) * 16 + g;  // this thread's rows: row, row + 8
  // nomm's row constants, from Q's tile 0 in use 0 (held to the last pass).
  float c_lo = 0.f, c_hi = 0.f;
  if constexpr (!P::kProducts) {
    ring.wait(0, total, load);
    c_lo = round_bf16(ld_swizzled(pair_tile(smem, 0), row, 0) * scale);
    c_hi = round_bf16(ld_swizzled(pair_tile(smem, 0), row + 8, 0) * scale);
  }
  // S of a key block from use n0 (`prev_held`: the use before it is still
  // read by a product in flight), or nomm's row constants.
  auto block_s = [&](float (&s)[32], int n0, bool prev_held) {
    if constexpr (P::kProducts) {
      pair_products<1>(
          ring, smem, n0, nd, total, load,
          [&](int, uint8_t* st, bool acc) {
            gemm_nt(s, desc_k_major(st), desc_k_major(st + kTileBytes), acc);
          },
          lane, prev_held);
      fence(s);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = (i & 2) ? c_hi : c_lo;
        asm volatile("" : "+f"(x));  // every key's softmax stays
        s[i] = x;
      }
    }
  };

  float row_m_lo = 0.f, row_m_hi = 0.f, inv_lo = 1.f, inv_hi = 1.f;
  if constexpr (P::kPasses == Passes::kOnline) {
    float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F, l_lo = 0.f, l_hi = 0.f;
    for (int j = 0; j < nkb; ++j) {
      float s[32];
      block_s(s, j * s_uses, false);
      float b_lo = -CUDART_INF_F, b_hi = -CUDART_INF_F;
      wide_scores<P>(s, j, seq_len, scale, t4, b_lo, b_hi);
      const float n_lo = fmaxf(m_lo, b_lo);
      const float n_hi = fmaxf(m_hi, b_hi);
      if (n_lo > -CUDART_INF_F) {
        l_lo = l_lo * P::exp(m_lo - n_lo) +
               wide_block_sum<P>(s, j, 0, n_lo, seq_len, t4);
        m_lo = n_lo;
      }
      if (n_hi > -CUDART_INF_F) {
        l_hi = l_hi * P::exp(m_hi - n_hi) +
               wide_block_sum<P>(s, j, 2, n_hi, seq_len, t4);
        m_hi = n_hi;
      }
    }
    row_m_lo = quad_max(m_lo);
    row_m_hi = quad_max(m_hi);
    inv_lo = 1.f / quad_sum(l_lo * P::exp(m_lo - row_m_lo));
    inv_hi = 1.f / quad_sum(l_hi * P::exp(m_hi - row_m_hi));
  } else if constexpr (P::kPasses == Passes::kSum) {
    float l_lo = 0.f, l_hi = 0.f;
    for (int j = 0; j < nkb; ++j) {
      float s[32];
      block_s(s, j * s_uses, false);
      float b_lo = -CUDART_INF_F, b_hi = -CUDART_INF_F;
      wide_scores<P>(s, j, seq_len, scale, t4, b_lo, b_hi);
      l_lo += wide_block_sum<P>(s, j, 0, 0.f, seq_len, t4);
      l_hi += wide_block_sum<P>(s, j, 2, 0.f, seq_len, t4);
    }
    inv_lo = 1.f / quad_sum(l_lo);
    inv_hi = 1.f / quad_sum(l_hi);
  } else if constexpr (P::kPasses == Passes::kMaxSum) {
    float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F;
    for (int j = 0; j < nkb; ++j) {
      float s[32];
      block_s(s, j * s_uses, false);
      wide_scores<P>(s, j, seq_len, scale, t4, m_lo, m_hi);
    }
    row_m_lo = quad_max(m_lo);
    row_m_hi = quad_max(m_hi);
    float l_lo = 0.f, l_hi = 0.f;
    for (int j = 0; j < nkb; ++j) {
      float s[32];
      block_s(s, (nkb + j) * s_uses, false);
      float b_lo = -CUDART_INF_F, b_hi = -CUDART_INF_F;
      wide_scores<P>(s, j, seq_len, scale, t4, b_lo, b_hi);
      l_lo += wide_block_sum<P>(s, j, 0, row_m_lo, seq_len, t4);
      l_hi += wide_block_sum<P>(s, j, 2, row_m_hi, seq_len, t4);
    }
    inv_lo = 1.f / quad_sum(l_lo);
    inv_hi = 1.f / quad_sum(l_hi);
  }

  // Last pass: S again, p formed and rounded, O's tiles += p V from the
  // block's two V uses; the first V use is released once the second's
  // product is issued, the second at the next block's first S product.
  float oacc[kWideTiles][32];
  uint32_t pa[16];
  float sum_lo = 0.f, sum_hi = 0.f;  // kDivide: the row sums of e
  float p0_lo = 0.f, p0_hi = 0.f;    // nomm: p of key 0
  float v0_lo = 0.f, v0_hi = 0.f;    // nomm: the row's own v[0]
  for (int j = 0; j < nkb; ++j) {
    const int n0 = n_last + j * per_last;
    float sacc[32];
    block_s(sacc, n0, j > 0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = j * kTileRows + nt * 8 + 2 * t4 + (i & 1);
        const float x = P::p(sacc[4 * nt + i], key, seq_len, scale,
                             i < 2 ? row_m_lo : row_m_hi,
                             i < 2 ? inv_lo : inv_hi);
        if constexpr (kDivide) {
          if (i < 2) {
            sum_lo += x;
          } else {
            sum_hi += x;
          }
        }
        sacc[4 * nt + i] = x;
      }
    }
    pack_a(pa, sacc);
    if constexpr (P::kProducts) {
      const int nv = n0 + nd;
      ring.wait(nv, total, load);
      wgmma_fence();
      gemm_rn(oacc[0], pa, desc_mn_major(pair_tile(smem, nv)), j > 0);
      gemm_rn(oacc[1], pa, desc_mn_major(pair_tile(smem, nv) + kTileBytes),
              j > 0);
      wgmma_commit();
      ring.wait(nv + 1, total, load);
      wgmma_fence();
      gemm_rn(oacc[2], pa, desc_mn_major(pair_tile(smem, nv + 1)), j > 0);
      gemm_rn(oacc[3], pa,
              desc_mn_major(pair_tile(smem, nv + 1) + kTileBytes), j > 0);
      wgmma_commit();
      wgmma_wait<1>();
      ring.release(nv, lane);
    } else {
      if (j == 0) {
        p0_lo = sacc[0];
        p0_hi = sacc[2];
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) asm volatile("" ::"r"(pa[i]));
      if (j > 0) ring.wait(n0, total, load);  // use 0 was waited for above
      if (j == t) {
        v0_lo = ld_swizzled(pair_tile(smem, n0) + kTileBytes, row, 0);
        v0_hi = ld_swizzled(pair_tile(smem, n0) + kTileBytes, row + 8, 0);
      }
      __syncwarp();
      ring.release(n0, lane);
    }
  }
  if constexpr (P::kProducts) {
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kWideTiles; ++c) fence(oacc[c]);
    ring.release(total - 1, lane);
  } else {
    const int src = lane & ~3;
    const float pl = __shfl_sync(0xffffffffu, round_bf16(p0_lo), src);
    const float ph = __shfl_sync(0xffffffffu, round_bf16(p0_hi), src);
#pragma unroll
    for (int c = 0; c < kWideTiles; ++c) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        oacc[c][4 * n] = oacc[c][4 * n + 1] = pl * v0_lo;
        oacc[c][4 * n + 2] = oacc[c][4 * n + 3] = ph * v0_hi;
      }
    }
  }

  // The CTA's column tiles, columns at or past D dropped; kDivide divides
  // by the row sum (as K3's store does), the others store O as it is.
  if constexpr (kDivide) {
    sum_lo = quad_sum(sum_lo);
    sum_hi = quad_sum(sum_hi);
  }
  const int row_lo = t * kTileRows + row;
  __nv_bfloat16* out = a.o + static_cast<size_t>(batch) * seq_len * a.o_ld +
                       static_cast<size_t>(head) * a.head_dim;
#pragma unroll
  for (int c = 0; c < kWideTiles; ++c) {
    const int col0 = (tile0 + c) * 64;
    if (c >= chunk_tiles) break;
    __nv_bfloat16* o_lo =
        out + static_cast<size_t>(row_lo) * a.o_ld + col0 + 2 * t4;
    __nv_bfloat16* o_hi = o_lo + 8 * static_cast<size_t>(a.o_ld);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (col0 + 8 * n >= a.head_dim) break;
      const float* x = &oacc[c][4 * n];
      if (row_lo < seq_len) {
        *reinterpret_cast<uint32_t*>(o_lo + 8 * n) =
            kDivide ? pack_bf16(x[0] / sum_lo, x[1] / sum_lo)
                    : pack_bf16(x[0], x[1]);
      }
      if (row_lo + 8 < seq_len) {
        *reinterpret_cast<uint32_t*>(o_hi + 8 * n) =
            kDivide ? pack_bf16(x[2] / sum_hi, x[3] / sum_hi)
                    : pack_bf16(x[2], x[3]);
      }
    }
  }
}

}  // namespace sm90

namespace sm90_host {

// Whether the core takes a head dim: a multiple of 8 from 8 to 2,048 (a
// head's TMA stride is a multiple of 16 bytes). The wrappers
// (ops/attention.py, ops/fused_block.py) run any other head dim up to
// 2,048 at the next multiple of 8, on heads zero-padded to it, with the
// true head dim's scale.
inline bool valid_head_dim(int head_dim) {
  return head_dim >= 8 && head_dim <= sm90::kAttnMaxHeadDim &&
         head_dim % 8 == 0;
}

// Launches a wide-head kernel (sm90::attention_wide<P>) of O's column
// tiles `chunk_tiles` a CTA (1 to sm90::kWideTiles; the kernels' entry
// points pass kWideTiles, their tests fewer). Returns cudaGetLastError(),
// or cudaErrorInvalidValue for a chunk outside 1 .. kWideTiles.
template <class P, class Kernel>
inline int launch_attention_wide(Kernel kernel, const CUtensorMap& tm_q,
                                 const CUtensorMap& tm_k,
                                 const CUtensorMap& tm_v, sm90::AttnArgs a,
                                 int batch, int num_heads,
                                 cudaStream_t stream, int chunk_tiles) {
  if (chunk_tiles < 1 || chunk_tiles > sm90::kWideTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (P::kBase2) a.scale = a.scale * 1.44269504088896341f;
  const int nkb = (a.seq_len + sm90::kTileRows - 1) / sm90::kTileRows;
  const int nd = sm90::attn_tiles(a.head_dim);
  const int nch = (nd + chunk_tiles - 1) / chunk_tiles;
  const size_t smem = sm90::pair_ring_smem();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(nch * nkb, num_heads, batch), 128, smem, stream>>>(
      tm_q, tm_k, tm_v, a, chunk_tiles);
  return static_cast<int>(cudaGetLastError());
}

// `kernels[NT - 1][mode]` runs sm90::attention_heads<P, groups, NT,
// stream>: mode 0 one warpgroup, 1 two, both resident; 2 two, streamed
// (rows 3 and 4 hold the streamed kernel in every mode: only mode 2 is
// chosen there, so nothing else is instantiated). Launches the resident
// kernel up to sm90::attn_resident_len(head_dim) (one warpgroup for heads
// of at most kAttnShortTiles tiles, as K3, else two) and the streamed one
// past it or when `stream_kv`, of NT = ceil(D / 64) 64-column tiles a
// head; past four tiles, `wide` (launch_attention_wide, `chunk_tiles` of
// O a CTA). `scale` is head_dim**-0.5 in f32; for a base-2 policy log2(e)
// is folded in here. Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a head dim that is not a multiple of 8 up to 2,048 or a length past
// sm90::kAttnMaxLen.
template <class P, class Kernel, class WideKernel>
inline int launch_attention(const Kernel (&kernels)[4][3], WideKernel wide,
                            const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                            const CUtensorMap& tm_v, sm90::AttnArgs a,
                            int batch, int num_heads, cudaStream_t stream,
                            bool stream_kv = false,
                            int chunk_tiles = sm90::kWideTiles) {
  if (!valid_head_dim(a.head_dim) || a.seq_len > sm90::kAttnMaxLen) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (sm90::attn_tiles(a.head_dim) > 4) {
    return launch_attention_wide<P>(wide, tm_q, tm_k, tm_v, a, batch,
                                    num_heads, stream, chunk_tiles);
  }
  if (P::kBase2) a.scale = a.scale * 1.44269504088896341f;
  const int nkb = (a.seq_len + sm90::kTileRows - 1) / sm90::kTileRows;
  const bool streamed =
      stream_kv || a.seq_len > sm90::attn_resident_len(a.head_dim);
  const int mode = streamed ? 2 : nkb <= sm90::kAttnShortTiles ? 0 : 1;
  const int groups = mode == 0 ? 1 : 2;
  const int nt = sm90::attn_tiles(a.head_dim);
  const Kernel kernel = kernels[nt - 1][mode];
  const size_t smem = sm90::attn_smem_bytes(
      streamed ? sm90::attn_ring_stages(nt) : nkb, groups, nt);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = streamed ? dim3((nkb + 1) / 2, num_heads, batch)
                             : dim3(num_heads, batch);
  kernel<<<grid, 128 * groups, smem, stream>>>(tm_q, tm_k, tm_v, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90_host
