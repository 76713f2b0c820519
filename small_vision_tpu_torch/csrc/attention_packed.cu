// Bidirectional attention on packed (B, L, H*D) bf16 tensors, forward, for
// Hopper (sm_90a), at any head dim D that is a multiple of 8 up to 2,048.
//
// Replaces: small_vision_tpu/ops/attention.py::_attn_kernel_packed (reached
// via pallas_attention_packed / fused_attention_packed). Per (batch, head):
//   S = (Q K^T) * scale * log2(e)                        (f32)
//   e = exp2(clamp(S, -80, 80)) * keymask                (f32; no max shift)
//   s = rowsum(e)                                        (f32, unrounded e)
//   O = (bf16(e) V) / s                                  (f32 sums, bf16 out)
// the same clamp stabiliser and the same rounding of e before the PV product
// as the TPU kernel. Keys past L get e = 0; query rows past L are not stored.
//
// Bound on this card: at the sampler's shapes (B=64, H=12, L=260, D=64)
// the 4*B*L*H*D*2 bytes of q, k, v and o (~102 MB, ~30 us at 3.35 TB/s)
// outweigh the 4*B*H*L^2*D flops (~13 GFLOP, ~13 us at 989 TFLOP/s), so
// the floor is memory; the exp2 of every score (B*H*L^2 ~ 52 M) is the
// next limit.
//
// Design: the (L, L) scores never leave the SM. One CTA takes one (batch,
// head) and reads its K and V once: its first thread starts TMA copies of
// them in 64-key blocks (a 3-D tensor map over (H*64, L, B), box (64, 64,
// 1), the 128-byte swizzle; rows past L arrive as zeros), each block on its
// own mbarrier, and they stay resident (80 KB at L=260; 13 blocks, L <= 832,
// fit the 227 KB a block can use). Its warpgroups (two, or one for short
// heads; see the grid below) walk the head's 64-row query tiles
// (warpgroup w of two takes tiles w, w + 2, ...), each from its own Q
// buffer, which its first thread refills by TMA once the tile's products
// are done, during the tile's epilogue. For a key block j a warpgroup runs
// S = Q K_j^T on wgmma (m64n64k16, both operands K-major from shared
// memory) as soon as block j has landed, the clamped exp2 and the mask,
// adds the unrounded f32 e to its row sums, packs e to bf16 (the
// accumulator's layout is wgmma's A-register layout) and runs O += e V_j on
// wgmma with V_j row-major through the transpose-B bit. The clamp replaces
// the max shift, so no online rescaling is needed and block j + 1's S
// product is issued together with block j's PV product, one commit and one
// wait for both. No warp is set aside as a producer: the copies are issued
// once (K, V) or once a tile (Q), and a ninth warp would cost the
// consumers registers (see below).
//
// What this does about the old kernel's costs: V is no longer staged
// transposed with 2-byte stores (8-way bank conflicts), and K and V are
// read once per head, not once per query tile (5 times at L=260). The first
// S product starts when Q and the first key block have landed, not after a
// synchronous prologue over the whole head. Shared memory at L=272 is
// 5 x 16 KB of K and V plus two 8 KB Q tiles (97 KB), so two CTAs (four
// warpgroups) share an SM.
//
// Registers: two 256-thread CTAs or four 128-thread CTAs an SM put four
// warps on each of the SM's four register files, 128 registers a thread. A warpgroup holds the S and
// O accumulators (64), e as the A operand (16), row sums and addresses;
// ptxas reports 108 and no spills. A second S accumulator (FA3's overlap of
// block j + 1's S with block j's exp2) would not fit; a producer warp would
// leave five warps on a register file and 96 registers a thread, under
// which ptxas serialises the wgmmas.
//
// The grid is B*H CTAs: 768 at B=64 (the sampler), 1,536 at B=128 (the
// training shapes). Long heads (4 or more 64-row tiles) take two
// warpgroups a CTA, two CTAs an SM: 2.9 and 5.8 waves; at L=260 (5 tiles)
// one warpgroup does 3 tiles and the other 2, and the ragged last tile (4
// rows at L=260, 1 at L=257) costs a whole tile's products. Short heads (at
// most 3 tiles: L=68 and L=164) take one warpgroup a CTA that walks all
// tiles, four CTAs an SM (42 and 58 KB): their time goes to the copies'
// latency more than to products, and four heads in flight on an SM hide it
// better than two heads with two warpgroups each.

// Head dims. A head is one 64-column tile (D <= 64), two (64 < D <= 128),
// three (<= 192) or four (<= 256): the template's NT. Each tile is a TMA
// box of a 4-D tensor map over (D, H, L, B), so columns at or past D
// arrive as zeros (D = 136 or 200: a ragged last tile), and a head
// narrower than its tiles never reads the next head's columns: the padded
// columns of Q and K add 0 to the scores, those of V give 0 columns of O,
// which the store drops. The scale is the true D's. Two tiles a head
// (D = 128, six heads at width 768) double K, V and Q in shared memory
// (193 KB at L = 260: one CTA of two warpgroups an SM) and O's accumulator
// (64 more registers a thread, so such a CTA takes up to 255); the
// products are the same per head-row, and the exps, B*H*L^2, halve with H.
//
// Long heads: K and V stream. Resident blocks fit up to L = 832 at D <= 64
// and 384 to 128 (13 and 6 blocks), but past 320 at D <= 64 only one CTA an
// SM. Past 320 and 384 (ViT-B/16@384: L = 576; ViT-L/16@512: 1,024 or
// 1,025 at D = 64; ViT-H/14@518: 1,369 at D = 80) the kernel's kStream
// instantiation keeps a ring of kRingStages K and V stages instead (5 of
// 16 KB at one tile a head, two CTAs an SM; 6 of 32 KB at two, one CTA),
// each with a full and an empty mbarrier (sm90.cuh's Ring). The grid
// becomes (query-tile pairs, H, B): a CTA takes two query tiles, one a
// warpgroup, and its two warpgroups walk the same key blocks in the same
// order, so one ring serves both: block j goes to stage j % kRingStages,
// and a stage is refilled once every consumer warp has released it, the
// ring kept kRingStages - 2 blocks ahead of the one waited for (each wait
// first issues that block; every consumer thread runs the same straight
// code and thread 0 alone copies, predicated: a thread-dependent branch
// inside the wgmma pipeline made ptxas serialise the products). Each
// warpgroup takes exactly one tile: when the tiles are odd in number (L =
// 1,025 has 17), the last CTA's second warpgroup recomputes the last tile
// and stores nothing, releasing the stages as the first does (a trip
// count that differs between the warpgroups made ptxas serialise the
// core's products). The CTAs of one head
// are neighbours in the grid, so K and V come from device memory about
// once and from L2 once a tile pair. The arithmetic, the order of the sums
// and the rounding are the resident kernel's, so every length gives the
// function of the plain version, and the lengths that were resident give
// the same bits either way. Without a max shift one pass stays one pass:
// nothing is rescaled. The row sum of up to 4,096 terms of at most 2^80
// is below 2^92, far inside f32. L goes up to 4,096, K4's limit.

// Wide heads: three or four tiles (128 < D <= 256; `heads=4` at width 768
// is D = 192, `heads=3` 256) stream at every length. A resident head would
// hold 2 (D = 256) or 3 key blocks, and a ring stage of K and V together
// (48 or 64 KB) leaves beside the two warpgroups' Q tiles (48 or 64 KB)
// room for 3 or 2 stages: the ring would run 1 or 0 blocks ahead, no copy
// in flight during the products. So there a stage holds one head of K or
// of V (24 or 32 KB, split_kv), block j's K and V are ring uses 2 j and 2 j
// + 1, and 7 stages (D <= 192) or 5 (D <= 256) keep the ring 5 or 3 uses
// ahead (222 and 230 KB of shared memory, one CTA an SM). Other choices
// weighed: one query tile a CTA with O's columns split between its two
// warpgroups halves O's registers but computes every S and exp twice;
// three stages of a smaller (32-key) block would change the order of the
// sums. A warp holds at most the use it waits for and the one before: V_j,
// its P V product in flight with K_{j+1}'s S product, while it waits for
// K_{j+1}; V_j and K_{j+1} are released together after the wait, K_0 after
// the first S product. Registers: O's accumulator is 96 or 128 a thread,
// with S (32) and e (16) under the 255 that one 256-thread CTA an SM
// allows (ptxas's report: the build log). The arithmetic and the order of
// the sums are D <= 128's: the same function of the plain version.

// Heads past four tiles (256 < D <= 2,048; `heads=2` at width 768 is D =
// 384, `heads=1` 768) run the wide path of the max-shift core
// (sm90_attention.cuh's attention_wide, its design and costs there) under
// this kernel's softmax as a policy, sm90::ClampExp2: e = exp2 of the
// clamped log2-scaled score, masked past L, summed unrounded over the row
// in the one pass that also forms O += bf16(e) V, and O divided by the sum
// at the store. A head's S is summed over its nd column tiles through a
// ring of 16 KB tile pairs (Q's and K's tile c), and O's columns are split
// four tiles a CTA, each chunk recomputing S and e (2 chunks at D = 384, 3
// at 768, 8 at 2,048): every chunk's S, e and sums are the same bits, so
// the chunk count changes no output bit (`attention_packed_fwd_chunked`).
// Shared memory 97 KB a CTA at every D, two CTAs an SM; O 128 registers a
// thread beside S 32 and e 16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_attention.cuh"

namespace {

constexpr int kMaxHeadDim = 2048;
constexpr int kMaxLen = 4096;
constexpr int kTile = sm90::kTileRows;
constexpr int kTileBytes = sm90::kTileBytes;
// Warpgroups a CTA: two, or one for heads of at most kShortTiles tiles.
constexpr int kShortTiles = 3;
constexpr float kClamp = 80.f;
constexpr int kSmemLimit = 232448;
constexpr int kSmemPerSM = 233472;  // blocks an SM holds: 1 KB each reserved

// Whether a ring stage holds one head of K or of V, not both (wide heads).
__host__ __device__ constexpr bool split_kv(int nt) { return nt > 2; }

// Stages of the streamed ring: two CTAs an SM at one tile a head, one at
// two or more (see kernel's launch bounds); at three and four as many
// single K or V blocks as fit.
template <int NT>
constexpr int kRingStages = NT == 1 ? 5 : NT == 2 ? 6 : NT == 3 ? 7 : 5;

// 1 KB to align the tiles; `stages` K and `stages` V blocks (split_kv:
// `stages` blocks of either) and one Q tile a warpgroup, each of nt
// 64-column tiles; barriers: one a stage (two when streamed: full and
// empty), one a Q tile.
__host__ __device__ constexpr size_t smem_bytes(int stages, int groups,
                                                int nt, bool stream = false) {
  return 1024 +
         static_cast<size_t>((split_kv(nt) ? 1 : 2) * stages + groups) * nt *
             kTileBytes +
         8 * static_cast<size_t>((stream ? 2 : 1) * stages + groups);
}
static_assert(2 * (smem_bytes(kRingStages<1>, 2, 1, true) + 1024) <=
                  kSmemPerSM,
              "two streamed CTAs an SM at one tile a head");
static_assert(smem_bytes(kRingStages<2>, 2, 2, true) <= kSmemLimit,
              "one streamed CTA an SM at two tiles a head");
static_assert(smem_bytes(kRingStages<3>, 2, 3, true) <= kSmemLimit &&
                  smem_bytes(kRingStages<3> + 1, 2, 3, true) > kSmemLimit,
              "the most single-block stages at three tiles a head");
static_assert(smem_bytes(kRingStages<4>, 2, 4, true) <= kSmemLimit &&
                  smem_bytes(kRingStages<4> + 1, 2, 4, true) > kSmemLimit,
              "the most single-block stages at four tiles a head");

// Whether a head of nkb key blocks stays resident: while its CTA fits an
// SM as often as the streamed one (two at one tile a head, L <= 320; one
// at two, L <= 384). Past that, resident heads ran one CTA an SM where the
// streamed kernel runs two, and read slower (PERF.md). Never at three or
// four tiles a head.
constexpr bool resident(int nkb, int nt) {
  return !split_kv(nt) &&
         (nt == 1 ? 2 : 1) * (smem_bytes(nkb, 2, nt) + 1024) <= kSmemPerSM;
}

// One tile a head: 128 registers a thread either way, two CTAs of two
// warpgroups, or four of one, an SM. Two tiles or more: half as many CTAs.
// kStream (two warpgroups only): K and V through the ring, grid (tile
// pairs, H, B); at three and four tiles, split_kv.
template <int kGroups, int NT, bool kStream>
__global__ void __launch_bounds__(128 * kGroups, (NT == 1 ? 4 : 2) / kGroups)
attention_packed_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            __nv_bfloat16* __restrict__ o, int seq_len,
                            int num_heads, int head_dim, float scale_log2) {
  constexpr int kHeadBytes = NT * kTileBytes;
  constexpr int kRing = kRingStages<NT>;
  constexpr bool kSplit = split_kv(NT);
  static_assert(kStream || !kSplit, "three or four tiles a head stream");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align_tiles(smem_raw);
  const int nkb = (seq_len + kTile - 1) / kTile;
  const int nqt = nkb;
  // Resident: block j of K and V in stage j, each loaded once. Streamed:
  // in stage j % kRing; kSplit: block j's K is ring use 2 j, its V 2 j + 1,
  // each in a stage of its own.
  const int stages = kStream ? kRing : nkb;
  const int uses = kSplit ? 2 * nkb : nkb;
  uint8_t* k_s = smem;                       // stage s at s * NT * 8 KB
  uint8_t* v_s = kSplit ? k_s : k_s + stages * kHeadBytes;
  uint8_t* q_s = v_s + stages * kHeadBytes;  // warpgroup w's at w * NT * 8 KB
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(q_s + kGroups * kHeadBytes);
  uint64_t* q_full = kv_full + stages;
  const sm90::Ring<kRing> ring{kv_full, q_full + kGroups};  // streamed only

  const int head = kStream ? blockIdx.y : blockIdx.x;
  const int batch = kStream ? blockIdx.z : blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // Resident: CTA (head, batch), warpgroup w walks tiles w, w + kGroups,
  // ... Streamed: CTA (x, head, batch), warpgroup w takes tile kGroups x +
  // w, exactly one, so that both run the same count of products (see the
  // ring in sm90.cuh); when the tiles are odd in number, the last CTA's
  // second warpgroup recomputes the last tile, releases the stages as the
  // first does, and stores no row.
  const int t_mine =
      kStream ? min(blockIdx.x * kGroups + warp / 4, nqt - 1) : warp / 4;
  const int rows =
      kStream && blockIdx.x * kGroups + warp / 4 >= nqt ? 0 : seq_len;

  // A head's NT tiles of 64 rows from `row`, into dst (zeros past D, L).
  auto load_head = [&](uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                       int row) {
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      sm90::tma_load_4d(dst + c * kTileBytes, map, bar, c * 64, head, row,
                        batch);
    }
  };
  // Key block j's K and V into stage s (resident, by the calling thread).
  auto load_kv = [&](int j, int s, uint64_t* bar) {
    sm90::mbar_arrive_expect_tx(bar, 2 * kHeadBytes);
    load_head(k_s + s * kHeadBytes, &tm_k, bar, j * kTile);
    load_head(v_s + s * kHeadBytes, &tm_v, bar, j * kTile);
  };
  // Streamed: the same where `issue` holds; every consumer thread calls it
  // and thread 0 alone copies, predicated (see sm90::Ring). kSplit: use j
  // is block j / 2's K (even) or V (odd).
  auto ring_load = [&](int j, int s, uint64_t* bar, bool issue) {
    const bool copy = issue && tid == 0;
    if constexpr (kSplit) {
      sm90::mbar_arrive_expect_tx_if(bar, kHeadBytes, copy);
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        sm90::tma_load_4d_if(k_s + s * kHeadBytes + c * kTileBytes,
                             (j & 1) ? &tm_v : &tm_k, bar, c * 64, head,
                             (j >> 1) * kTile, batch, copy);
      }
      return;
    }
    sm90::mbar_arrive_expect_tx_if(bar, 2 * kHeadBytes, copy);
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      sm90::tma_load_4d_if(k_s + s * kHeadBytes + c * kTileBytes, &tm_k, bar,
                           c * 64, head, j * kTile, batch, copy);
      sm90::tma_load_4d_if(v_s + s * kHeadBytes + c * kTileBytes, &tm_v, bar,
                           c * 64, head, j * kTile, batch, copy);
    }
  };
  if (tid == 0) {
    if constexpr (kStream) {
      ring.init(4 * kGroups);
    } else {
      for (int j = 0; j < nkb; ++j) sm90::mbar_init(&kv_full[j], 1);
    }
    for (int w = 0; w < kGroups; ++w) sm90::mbar_init(&q_full[w], 1);
    sm90::fence_barrier_init();
    // The first Q tiles, then the key blocks in order.
    for (int w = 0; w < kGroups && (kStream || w < nqt); ++w) {
      const int t = kStream ? min(blockIdx.x * kGroups + w, nqt - 1) : w;
      sm90::mbar_arrive_expect_tx(&q_full[w], kHeadBytes);
      load_head(q_s + w * kHeadBytes, &tm_q, &q_full[w], t * kTile);
    }
    if constexpr (kStream) {
      ring.prime(uses, ring_load);
    } else {
      for (int j = 0; j < nkb; ++j) load_kv(j, j, &kv_full[j]);
    }
  }
  __syncthreads();

  const int wg = warp / 4;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int tok_stride = num_heads * head_dim;
  __nv_bfloat16* out = o + static_cast<size_t>(batch) * seq_len * tok_stride +
                       head * head_dim;
  uint8_t* my_q = q_s + wg * kHeadBytes;
  auto stage = [&](int j) { return kStream ? ring.stage(j) : j; };
  // Key block j's K and V uses (one use for both unless kSplit).
  auto k_use = [&](int j) { return kSplit ? 2 * j : j; };
  auto v_use = [&](int j) { return kSplit ? 2 * j + 1 : j; };
  // Key block j's K (and V unless kSplit) has landed (streamed: the ring's
  // wait, which first issues use k_use(j) + kAhead).
  auto wait_kv = [&](int j) {
    if constexpr (kStream) {
      ring.wait(k_use(j), uses, ring_load);
    } else {
      sm90::mbar_wait(&kv_full[j], 0);
    }
  };
  // S = Q K_j^T over the head's NT tiles of columns.
  auto scores = [&](float (&sacc)[32], int j) {
    uint8_t* k_j = k_s + stage(k_use(j)) * kHeadBytes;
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      sm90::gemm_nt(sacc, sm90::desc_k_major(my_q + c * kTileBytes),
                    sm90::desc_k_major(k_j + c * kTileBytes), c > 0);
    }
  };

  // Once a tile's products are done, the warpgroup's first thread starts
  // the copy of its next tile into the same buffer.
  auto refill_q = [&](int t) {
    if (kStream || t + kGroups >= nqt) return;
    if (wg == 0) {
      sm90::named_barrier<1>(128);
    } else {
      sm90::named_barrier<2>(128);
    }
    if (tid % 128 == 0) {
      sm90::mbar_arrive_expect_tx(&q_full[wg], kHeadBytes);
      load_head(my_q, &tm_q, &q_full[wg], (t + kGroups) * kTile);
    }
  };

  for (int t = t_mine, use = 0; kStream ? use < 1 : t < nqt;
       t += kGroups, ++use) {
    sm90::mbar_wait(&q_full[wg], use & 1);
    float sacc[32], oacc[NT][32];
    uint32_t pa[16];
    float sum_lo = 0.f, sum_hi = 0.f;  // rows g and g + 8, this lane's keys

    wait_kv(0);
    sm90::wgmma_fence();
    scores(sacc, 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence(sacc);
    if constexpr (kSplit) ring.release(k_use(0), lane);

    for (int j = 0; j < nkb; ++j) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = j * kTile + nt * 8 + 2 * t4 + (i & 1);
          const float x =
              fminf(fmaxf(sacc[4 * nt + i] * scale_log2, -kClamp), kClamp);
          const float e = key < seq_len ? exp2f(x) : 0.f;
          if (i < 2) {
            sum_lo += e;
          } else {
            sum_hi += e;
          }
          sacc[4 * nt + i] = e;
        }
      }
      sm90::pack_a(pa, sacc);
      if constexpr (kSplit) ring.wait(v_use(j), uses, ring_load);
      sm90::wgmma_fence();
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        sm90::gemm_rn(oacc[c], pa,
                      sm90::desc_mn_major(v_s + stage(v_use(j)) * kHeadBytes +
                                          c * kTileBytes),
                      j > 0);
      }
      if (j + 1 < nkb) {
        wait_kv(j + 1);
        scores(sacc, j + 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NT; ++c) sm90::fence(oacc[c]);
      sm90::fence(sacc);
      // Block j's K and V are read: this warp releases its stage (kSplit:
      // V_j's and, its S product done, K_{j+1}'s).
      if constexpr (kStream) ring.release(v_use(j), lane);
      if constexpr (kSplit) ring.release_if(k_use(j + 1), lane, j + 1 < nkb);
    }

    refill_q(t);

    // The four lanes of a group hold disjoint keys of the same rows.
    sum_lo = sm90::quad_sum(sum_lo);
    sum_hi = sm90::quad_sum(sum_hi);
    const int row_lo = t * kTile + (warp % 4) * 16 + g;
    const int row_hi = row_lo + 8;
    __nv_bfloat16* o_lo = out + static_cast<size_t>(row_lo) * tok_stride +
                          2 * t4;
    __nv_bfloat16* o_hi = o_lo + 8 * static_cast<size_t>(tok_stride);
#pragma unroll
    for (int c = 0; c < NT; ++c) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = c * 64 + 8 * nt;  // padded columns are dropped
        if (col >= head_dim) break;
        if (row_lo < rows) {
          *reinterpret_cast<uint32_t*>(o_lo + col) = sm90::pack_bf16(
              oacc[c][4 * nt] / sum_lo, oacc[c][4 * nt + 1] / sum_lo);
        }
        if (row_hi < rows) {
          *reinterpret_cast<uint32_t*>(o_hi + col) = sm90::pack_bf16(
              oacc[c][4 * nt + 2] / sum_hi, oacc[c][4 * nt + 3] / sum_hi);
        }
      }
    }
  }
}

// Heads past four tiles: the wide core under K3's softmax.
__global__ void __launch_bounds__(128, 2)
attention_packed_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const sm90::AttnArgs a, int chunk_tiles) {
  extern __shared__ uint8_t smem_raw[];
  sm90::attention_wide<sm90::ClampExp2>(smem_raw, &tm_q, &tm_k, &tm_v, a,
                                        chunk_tiles);
}

template <int kGroups, int NT, bool kStream>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, void* o, int batch, int seq_len,
                   int num_heads, int head_dim, float scale_log2,
                   cudaStream_t s) {
  const int nkb = (seq_len + kTile - 1) / kTile;
  const size_t smem = kStream
                          ? smem_bytes(kRingStages<NT>, kGroups, NT, true)
                          : smem_bytes(nkb, kGroups, NT);
  cudaError_t err = cudaFuncSetAttribute(
      attention_packed_fwd_kernel<kGroups, NT, kStream>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid = kStream ? dim3((nkb + kGroups - 1) / kGroups, num_heads,
                                   batch)
                            : dim3(num_heads, batch);
  attention_packed_fwd_kernel<kGroups, NT, kStream>
      <<<grid, 128 * kGroups, smem, s>>>(tq, tk, tv,
                                         static_cast<__nv_bfloat16*>(o),
                                         seq_len, num_heads, head_dim,
                                         scale_log2);
  return cudaGetLastError();
}

// The resident kernel where a head's K and V fit (one warpgroup a CTA for
// short heads, as before), else, or when `stream`, the streamed one; at
// three or four tiles a head, the streamed one always.
template <int NT>
cudaError_t launch_nt(const CUtensorMap& tq, const CUtensorMap& tk,
                      const CUtensorMap& tv, void* o, int batch, int seq_len,
                      int num_heads, int head_dim, float scale_log2,
                      bool stream, cudaStream_t s) {
  const int nkb = (seq_len + kTile - 1) / kTile;
  if constexpr (split_kv(NT)) {  // wide heads stream at every length
    return launch<2, NT, true>(tq, tk, tv, o, batch, seq_len, num_heads,
                               head_dim, scale_log2, s);
  } else {
    if (stream || !resident(nkb, NT)) {
      return launch<2, NT, true>(tq, tk, tv, o, batch, seq_len, num_heads,
                                 head_dim, scale_log2, s);
    }
    return nkb <= kShortTiles
               ? launch<1, NT, false>(tq, tk, tv, o, batch, seq_len,
                                      num_heads, head_dim, scale_log2, s)
               : launch<2, NT, false>(tq, tk, tv, o, batch, seq_len,
                                      num_heads, head_dim, scale_log2, s);
  }
}

int run(const void* q, const void* k, const void* v, void* o, int batch,
        int seq_len, int num_heads, int head_dim, float scale_log2,
        bool stream, int chunk_tiles, void* stream_ptr) {
  if (head_dim < 8 || head_dim > kMaxHeadDim || head_dim % 8 != 0 ||
      seq_len > kMaxLen) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tq, tk, tv;
  if (!sm90_host::packed_head_map_d(&tq, q, batch, seq_len, num_heads,
                                    head_dim) ||
      !sm90_host::packed_head_map_d(&tk, k, batch, seq_len, num_heads,
                                    head_dim) ||
      !sm90_host::packed_head_map_d(&tv, v, batch, seq_len, num_heads,
                                    head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if ((head_dim + 63) / 64 > 4) {
    const sm90::AttnArgs args{0, 0, 0, static_cast<__nv_bfloat16*>(o),
                              num_heads * head_dim, seq_len, head_dim,
                              scale_log2};
    return sm90_host::launch_attention_wide<sm90::ClampExp2>(
        attention_packed_wide_kernel, tq, tk, tv, args, batch, num_heads, s,
        chunk_tiles);
  }
  cudaError_t (*const by_tiles[4])(const CUtensorMap&, const CUtensorMap&,
                                   const CUtensorMap&, void*, int, int, int,
                                   int, float, bool, cudaStream_t) = {
      launch_nt<1>, launch_nt<2>, launch_nt<3>, launch_nt<4>};
  const cudaError_t err =
      by_tiles[(head_dim + 63) / 64 - 1](tq, tk, tv, o, batch, seq_len,
                                         num_heads, head_dim, scale_log2,
                                         stream, s);
  return static_cast<int>(err);
}

}  // namespace

// Largest head dim the kernel takes; any multiple of 8 up to it.
extern "C" int attention_packed_max_head_dim() { return kMaxHeadDim; }

// Largest sequence length the kernel takes at a head dim: 4,096 at every
// one (K and V stream past the resident limit; K4 takes as much).
extern "C" int attention_packed_max_len(int) { return kMaxLen; }

// q, k, v, o: (B, L, H*head_dim) bf16, contiguous, 16-byte aligned;
// head_dim a multiple of 8 up to 2,048, L up to 4,096. scale_log2 =
// head_dim**-0.5 * log2(e) in f32. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a head dim or length past the limits or a
// tensor map that cannot be encoded.
extern "C" int attention_packed_fwd(const void* q, const void* k,
                                    const void* v, void* o, int batch,
                                    int seq_len, int num_heads, int head_dim,
                                    float scale_log2, void* stream) {
  return run(q, k, v, o, batch, seq_len, num_heads, head_dim, scale_log2,
             false, sm90::kWideTiles, stream);
}

// attention_packed_fwd with K and V streamed at every length, also where
// they would stay resident (for tests and measurement: the same bits).
extern "C" int attention_packed_fwd_streamed(const void* q, const void* k,
                                             const void* v, void* o,
                                             int batch, int seq_len,
                                             int num_heads, int head_dim,
                                             float scale_log2, void* stream) {
  return run(q, k, v, o, batch, seq_len, num_heads, head_dim, scale_log2,
             true, sm90::kWideTiles, stream);
}

// attention_packed_fwd with `chunk_tiles` (1 to 4) of O's 64-column tiles
// a CTA past head dim 256, not 4 (for tests: every chunk count gives the
// same bits).
extern "C" int attention_packed_fwd_chunked(const void* q, const void* k,
                                            const void* v, void* o,
                                            int batch, int seq_len,
                                            int num_heads, int head_dim,
                                            float scale_log2,
                                            int chunk_tiles, void* stream) {
  return run(q, k, v, o, batch, seq_len, num_heads, head_dim, scale_log2,
             false, chunk_tiles, stream);
}
