// Bidirectional attention on [B, L, H, D] bf16 tensors with the max-shift
// softmax, backward, for Hopper (sm_90a), at any head dim D that is a
// multiple of 8 up to 2,048.
//
// Replaces: small_vision_tpu/ops/attention.py::_attn_bwd_kernel (reached
// via _pallas_attention_bwd_impl, the custom VJP of fused_attention). Per
// (batch, head), recomputing the forward's probabilities:
//   S  = (Q K^T) * scale, keys past L at -inf;  m = rowmax(S)
//   P  = exp(S - m) / rowsum(exp(S - m))                            (f32)
//   dV = bf16(P)^T dO
//   dP = dO V^T                                                     (f32)
//   dS = bf16(P * (dP - rowsum(dP * P)))
//   dQ = (dS K) * scale;   dK = (dS^T Q) * scale
// with f32 sums and bf16 outputs: the TPU kernel's formulas and rounding
// points (P stays f32 inside dS, is rounded for dV; scale is applied to the
// f32 products, where the packed backward folds it into an operand). The
// exp is that of K7's production softmax (`SoftmaxExp2`,
// sm90_attention.cuh): with S2 = (Q K^T) * scale * log2(e) and m2 =
// rowmax(S2), P = exp2(S2 - m2) * r, r = 1 / rowsum, by ex2.
//
// Bound on this card: at B=128, H=12, L=257 the 7*B*L*H*64*2 bytes of q, k,
// v, dO, dq, dk and dv (354 MB, 0.106 ms at 3.35 TB/s) outweigh the five
// products of 2*B*H*L^2*64 flops (65 GFLOP, 0.066 ms at 989 TFLOP/s); the
// exp2 of every score, three times, is the next limit.
//
// Design: the packed backward's (attention_packed_bwd.cu), so that every
// output element is summed by one warpgroup's accumulator in a fixed
// order: no atomics, and two launches give the same bits. A contiguous
// [B, L, H, D] tensor is the packed (B, L, H*D) one, so the same 4-D TMA
// map over (D, H, L, B), box (64, 1, 64, 1) with the 128-byte swizzle,
// reads a head's 64 rows in place and fills rows at or past L, and columns
// at or past D, with zeros.
//  (a) attn_unpacked_bwd_dq_sm90: one CTA per (64-query tile, head, batch).
//      Its consumer warpgroup holds the tile's Q and dO; a producer warp
//      streams the head's 64-key blocks of K and V twice through a
//      two-stage ring. Pass 1 computes S and dP and keeps, per lane and
//      row, a running max of S2, the sum of e = exp2(S2 - max) and of
//      dP * e, both rescaled when the max grows; the four lanes of a row
//      then merge into m2, r = 1 / rowsum and c = rowsum(dP * P), stored
//      to the (B, H, L) f32 scratch. Pass 2 recomputes S and dP, forms
//      dS = bf16(P * (dP - c)) and accumulates dQ += dS K.
//  (b) attn_unpacked_bwd_dkdv_sm90: one CTA per (64-key tile, head, batch).
//      Its consumer warpgroup holds the tile's K and V; the producer warp
//      streams 64-query blocks of Q and dO with their m2, r and c. For each
//      block it computes S^T = K Q^T and dP^T = V dO^T, forms P^T and dS^T
//      in registers, and accumulates dV += bf16(P^T) dO and dK += dS^T Q.
// Every product is a wgmma m64nNk16 (bf16 in, f32 accumulate) of one
// warpgroup. The score products read both operands from shared memory,
// K-major; the updates take A from registers (the scores' accumulator
// layout, packed to bf16) and B from the same row-major tile through the
// transpose-B bit. In (a)'s pass 1 and in (b), S is issued before dP as
// its own commit group, so that the exp2 of S runs while dP is computed;
// (a)'s pass 2 waits for both (split there, ptxas serialised the wgmmas
// for want of registers, C7511, and (a) read 5 % slower at L=257 and 13 %
// at L=1,024 on this card). dQ and dK are scaled in f32 at the store, rows
// < L only.
//
// Masks: keys past L enter pass 1 at -inf before the max, as the TPU
// kernel's select does, and get P = 0 in pass 2. Queries past L get r = 0
// and m2 = c = 0 in (b), so their P is 0 whatever their (zero) scores. A
// key row past L in (b) may overflow (0 - m2 of a very negative row): rows
// of a product do not mix and it is not stored.
//
// The ragged edge: a last block of at most 16 rows (L=257: 1 row; L=68: 4)
// is computed 16 wide (m64n16k16, one contraction step in the update), so
// its products and exp2 cost a quarter of a full block's. Shared memory
// does not grow with L: (a) 49 KB and 128 registers a thread, three CTAs
// an SM; (b) 50 KB and 168 registers (four 64 x 64 f32 accumulators), two.
//
// Head dims, as in K4 (attention_packed_bwd.cu): a head is NT = 1 (D <=
// 64), 2 (<= 128), 3 or 4 (<= 256) tiles of 64 columns, each a TMA box that
// arrives as zeros past D, so the padded columns add 0 to every score and
// dP and give 0 columns of dQ, dK and dV, which the stores drop. The
// scale is f32(D**-0.5). At NT = 2 every tile doubles: (a) 97 KB and its
// dQ accumulator 64 registers, two CTAs an SM; (b) 98 KB and the dK and
// dV accumulators 128 registers, one CTA an SM with up to 255 a thread.
// The length limit stays 4,096 at every head dim.
//
// Wide heads, NT = 3 or 4 (128 < D <= 256), K4's answer: (a) as it is (1
// KB + 6 x NT x 8 KB, 145 or 193 KB, one CTA an SM; dQ 96 or 128
// registers). (b) would hold dK and dV in 192 or 256 registers a thread,
// so there (kCols) the grid's first axis takes each key tile twice and
// half h accumulates the column tiles 2 h and 2 h + 1 of dK and dV only
// (128 registers), recomputing S^T and dP^T over all of D; the two halves
// of a tile are neighbours in the grid, so Q and dO come from L2 the
// second time. A stage's Q and dO keep room for four tiles each (2 stages,
// 194 KB at NT = 4, 178 KB at 3): at NT = 3 the fourth is never written,
// and the second half's products with it land in accumulator columns
// 192-255, which the store drops. Every output element still comes from
// one accumulator in a fixed order: no atomics, the same bits launch to
// launch, and the arithmetic of NT <= 2, whose kernels are unchanged.
//
// Past four tiles (256 < D <= 2,048: `heads=2` at width 768 is D = 384,
// `heads=1` 768) the backward runs the wide kernels of
// sm90_attention_bwd.cuh (their design and costs there) under this file's
// softmax (kShift true): (r) m2, r and c, (a) dQ four column tiles a CTA,
// (b) dK and dV two each, every operand through a ring of 16 KB tile
// pairs, each chunk recomputing S and dP. The formulas and rounding points
// are the ones above (without the narrow last block: every block is 64
// wide, its keys past L masked).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "sm90_attention_bwd.cuh"

namespace {

constexpr int kMaxHeadDim = 2048;
constexpr int kTile = sm90::kTileRows;
constexpr int kTileBytes = sm90::kTileBytes;
constexpr int kStages = 2;
constexpr int kConsumers = 128;  // one warpgroup
constexpr int kNarrow = 16;      // a last block this short is 16 wide
constexpr float kLog2e = 1.44269504088896341f;
// Longest sequence the kernels take. Shared memory does not grow with L;
// this is the longest length the card's tests hold the kernels at.
constexpr int kMaxLen = 4096;

// (a): Q, dO; kStages x (K, V); barriers. (b): K, V; kStages x (Q, dO);
// kStages x (m2, r, c) [64] f32; barriers. Each operand is nt tiles (in
// (b) at three or four tiles a head, Q and dO kOpTiles each). Plus 1 KB to
// align the tiles to 1024 bytes.
constexpr int kColTiles = 2;             // (b) kCols: dK, dV tiles a CTA
constexpr int kOpTiles = 2 * kColTiles;  // (b) kCols: a Q or dO buffer
constexpr size_t dq_smem(int nt) {
  return 1024 + (2 + 2 * kStages) * nt * kTileBytes + 8 * (1 + 2 * kStages);
}
constexpr size_t dkdv_smem(int nt) {
  const int op = nt > 2 ? kOpTiles : nt;
  return 1024 + (2 * nt + 2 * kStages * op) * kTileBytes +
         kStages * 3 * kTile * 4 + 8 * (1 + 2 * kStages);
}
static_assert(dq_smem(4) <= 232448 && dkdv_smem(4) <= 232448,
              "one CTA an SM at four tiles a head");

// A head's NT tiles of 64 rows from `row` (zeros past D and L).
template <int NT>
__device__ __forceinline__ void load_head(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int head, int row,
                                          int batch) {
#pragma unroll
  for (int c = 0; c < NT; ++c) {
    sm90::tma_load_4d(dst + c * kTileBytes, map, bar, c * 64, head, row,
                      batch);
  }
}

// D (64 x 16, f32) [+]= A B^T over 16 columns, B's first 16 rows, both
// K-major in shared memory: the m64n64 accumulator's n-tiles 0 and 1.
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The scores of a block of kNT * 8 rows of B (kNT = 8: 64, or 2: 16):
// d = A B^T over the head's NT tiles of columns, both K-major.
template <int kNT, int NT>
__device__ __forceinline__ void gemm_scores(float (&d)[32], const uint8_t* a,
                                            const uint8_t* b) {
#pragma unroll
  for (int c = 0; c < NT; ++c) {
    const uint64_t da = sm90::desc_k_major(a + c * kTileBytes);
    const uint64_t db = sm90::desc_k_major(b + c * kTileBytes);
    if constexpr (kNT == 8) {
      sm90::gemm_nt(d, da, db, c > 0);
    } else {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wgmma_ss_n16(d, da + ks * sm90::kKMajorStep,
                     db + ks * sm90::kKMajorStep, c > 0 || ks > 0);
      }
    }
  }
}

// d[c] += P B[c] over the block's kNT * 8 rows, for each of the head's NT
// tiles of columns of B (MN-major).
template <int kNT, int NT>
__device__ __forceinline__ void gemm_update(float (&d)[NT][32],
                                            const uint32_t (&p)[16],
                                            const uint8_t* b) {
#pragma unroll
  for (int c = 0; c < NT; ++c) {
    const uint64_t db = sm90::desc_mn_major(b + c * kTileBytes);
#pragma unroll
    for (int ks = 0; ks < kNT / 2; ++ks) {
      const uint32_t a[4] = {p[4 * ks], p[4 * ks + 1], p[4 * ks + 2],
                             p[4 * ks + 3]};
      sm90::wgmma_rs(d[c], a, db + ks * sm90::kMNMajorStep, 1);
    }
  }
}

template <int NT>
__device__ __forceinline__ void fence_head(float (&d)[NT][32]) {
#pragma unroll
  for (int c = 0; c < NT; ++c) sm90::fence(d[c]);
}

// Stores a head's NT accumulators, dropping columns at or past head_dim.
template <int NT>
__device__ __forceinline__ void store_head(__nv_bfloat16* out, size_t ld,
                                           int row, int rows,
                                           const float (&d)[NT][32],
                                           float f, int t4, int head_dim) {
#pragma unroll
  for (int c = 0; c < NT; ++c) {
    sm90::store_acc(out + c * 64, ld, row, rows, d[c], f, f, t4,
                    head_dim - c * 64);
  }
}

// sm90::fence and sm90::pack_a over the first kNT n-tiles only.
template <int kNT>
__device__ __forceinline__ void fence_tiles(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 4 * kNT; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int kNT>
__device__ __forceinline__ void pack_tiles(uint32_t (&p)[16],
                                           const float (&d)[32]) {
#pragma unroll
  for (int j = 0; j < kNT / 2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[4 * j + e] = sm90::pack_bf16(d[8 * j + 2 * e], d[8 * j + 2 * e + 1]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&d)[NT][32]) {
#pragma unroll
  for (int c = 0; c < NT; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) d[c][i] = 0.f;
  }
}

// S = A B^T (into s) and dP = dA dB^T (into dp) of one block, over the
// head's NT tiles; returns once S has landed. kSplit: as two commit
// groups, dP still in flight; else one group. Either way the caller reads
// dP only after dp_landed. (Fencing dP here in the one-group case made
// ptxas serialise (a)'s wgmmas, C7511.)
template <int kNT, int NT, bool kSplit>
__device__ __forceinline__ void scores_then_dp(float (&s)[32],
                                               float (&dp)[32],
                                               const uint8_t* a,
                                               const uint8_t* d_a,
                                               const uint8_t* b,
                                               const uint8_t* d_b) {
  sm90::wgmma_fence();
  gemm_scores<kNT, NT>(s, a, b);
  if constexpr (kSplit) sm90::wgmma_commit();
  gemm_scores<kNT, NT>(dp, d_a, d_b);
  sm90::wgmma_commit();
  if constexpr (kSplit) {
    sm90::wgmma_wait<1>();
  } else {
    sm90::wgmma_wait<0>();
  }
  fence_tiles<kNT>(s);
}

template <int kNT>
__device__ __forceinline__ void dp_landed(float (&dp)[32]) {
  sm90::wgmma_wait<0>();
  fence_tiles<kNT>(dp);
}

// (a)'s per-lane state of pass 1 for its rows g (h = 0) and g + 8 (h = 1):
// the running max of S2, and the sums of e and of dP * e at that max.
struct RowSums {
  float m[2], l[2], pe[2];
};

// Pass 1 over one block of keys key0 .. key0 + 8 kNT - 1 (kv: its K tiles,
// then its V tiles); kMask: the block holds keys at or past L.
template <int kNT, int NT, bool kMask>
__device__ __forceinline__ void dq_pass1(RowSums& st, const uint8_t* q_s,
                                         const uint8_t* do_s,
                                         const uint8_t* kv, int key0,
                                         int seq_len, float scale_log2,
                                         int t4) {
  float s[32], dp[32];
  scores_then_dp<kNT, NT, true>(s, dp, q_s, do_s, kv,
                                kv + NT * kTileBytes);
  float bm[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x = s[4 * nt + i] * scale_log2;
      if (kMask && key0 + nt * 8 + 2 * t4 + (i & 1) >= seq_len) {
        x = -CUDART_INF_F;
      }
      s[4 * nt + i] = x;
      bm[i >> 1] = fmaxf(bm[i >> 1], x);
    }
  }
  float shift[2], alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float n = fmaxf(st.m[h], bm[h]);
    // No key of this lane yet (n = -inf): e = 0 and alpha = 0, no NaN.
    shift[h] = n == -CUDART_INF_F ? 0.f : n;
    alpha[h] = sm90::exp2_ftz(st.m[h] - shift[h]);
    st.m[h] = n;
  }
#pragma unroll
  for (int i = 0; i < 4 * kNT; ++i) {
    s[i] = sm90::exp2_ftz(s[i] - shift[(i >> 1) & 1]);
  }
  dp_landed<kNT>(dp);
  float le[2] = {0.f, 0.f}, pee[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4 * kNT; ++i) {
    le[(i >> 1) & 1] += s[i];
    pee[(i >> 1) & 1] += dp[i] * s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    st.l[h] = st.l[h] * alpha[h] + le[h];
    st.pe[h] = st.pe[h] * alpha[h] + pee[h];
  }
}

// Pass 2 over one block of keys: dS, then dq += dS K.
template <int kNT, int NT, bool kMask>
__device__ __forceinline__ void dq_pass2(float (&dq)[NT][32],
                                         const uint8_t* q_s,
                                         const uint8_t* do_s,
                                         const uint8_t* kv, int key0,
                                         int seq_len, float scale_log2,
                                         const float (&m)[2],
                                         const float (&r)[2],
                                         const float (&c)[2], int t4) {
  float s[32], dp[32];
  scores_then_dp<kNT, NT, false>(s, dp, q_s, do_s, kv,
                                 kv + NT * kTileBytes);
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = i >> 1;
      const bool masked =
          kMask && key0 + nt * 8 + 2 * t4 + (i & 1) >= seq_len;
      s[4 * nt + i] =
          masked ? 0.f
                 : sm90::exp2_ftz(s[4 * nt + i] * scale_log2 - m[h]) * r[h];
    }
  }
  dp_landed<kNT>(dp);
#pragma unroll
  for (int i = 0; i < 4 * kNT; ++i) {
    dp[i] = s[i] * (dp[i] - c[(i >> 1) & 1]);
  }
  uint32_t ds[16];
  pack_tiles<kNT>(ds, dp);
  sm90::wgmma_fence();
  gemm_update<kNT, NT>(dq, ds, kv);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  fence_head<NT>(dq);
}

template <int NT>
__global__ void __launch_bounds__(kConsumers + 32,
                                  NT == 1 ? 3 : NT == 2 ? 2 : 1)
attn_unpacked_bwd_dq_sm90(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          __nv_bfloat16* __restrict__ dq,
                          float* __restrict__ m_out, float* __restrict__ r_out,
                          float* __restrict__ c_out, int seq_len,
                          int num_heads, int head_dim, float scale_log2,
                          float scale) {
  constexpr int kHeadBytes = NT * kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align_tiles(smem_raw);
  uint8_t* q_s = smem;
  uint8_t* do_s = smem + kHeadBytes;
  uint8_t* ring = smem + 2 * kHeadBytes;  // stage s: K at 2 s, V at 2 s + 1
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(ring + 2 * kStages * kHeadBytes);
  uint64_t* qdo_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int qt = blockIdx.x;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int nkb = (seq_len + kTile - 1) / kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  if (tid == kConsumers) {
    sm90::mbar_init(qdo_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // producer
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(qdo_full, 2 * kHeadBytes);
      load_head<NT>(q_s, &tm_q, qdo_full, head, qt * kTile, batch);
      load_head<NT>(do_s, &tm_do, qdo_full, head, qt * kTile, batch);
      for (int n = 0; n < 2 * nkb; ++n) {  // both passes over the keys
        const int s = n % kStages;
        const int kb = n < nkb ? n : n - nkb;
        if (n >= kStages) sm90::mbar_wait(&empty[s], (n / kStages - 1) & 1);
        uint8_t* st = ring + 2 * s * kHeadBytes;
        sm90::mbar_arrive_expect_tx(&full[s], 2 * kHeadBytes);
        load_head<NT>(st, &tm_k, &full[s], head, kb * kTile, batch);
        load_head<NT>(st + kHeadBytes, &tm_v, &full[s], head, kb * kTile,
                      batch);
      }
    }
    return;
  }

  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int row_lo = qt * kTile + warp * 16 + g;  // and row_lo + 8
  // The last block: 16 wide when it holds at most 16 keys.
  const bool narrow = seq_len - (nkb - 1) * kTile <= kNarrow;
  sm90::mbar_wait(qdo_full, 0);

  RowSums st = {{-CUDART_INF_F, -CUDART_INF_F}, {0.f, 0.f}, {0.f, 0.f}};
  int n = 0;
  for (int kb = 0; kb < nkb; ++kb, ++n) {
    const int s = n % kStages;
    sm90::mbar_wait(&full[s], (n / kStages) & 1);
    const uint8_t* kv = ring + 2 * s * kHeadBytes;
    const int key0 = kb * kTile;
    if (kb + 1 < nkb) {
      dq_pass1<8, NT, false>(st, q_s, do_s, kv, key0, seq_len, scale_log2,
                             t4);
    } else if (narrow) {
      dq_pass1<2, NT, true>(st, q_s, do_s, kv, key0, seq_len, scale_log2,
                            t4);
    } else {
      dq_pass1<8, NT, true>(st, q_s, do_s, kv, key0, seq_len, scale_log2,
                            t4);
    }
    sm90::mbar_arrive(&empty[s]);
  }
  // Merge the row's four lanes. Key 0 is in every row, so its max is
  // finite; a lane that saw only masked keys has m = -inf and weight 0.
  float m[2], r[2], c[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = sm90::quad_max(st.m[h]);
    const float f = sm90::exp2_ftz(st.m[h] - m[h]);
    const float l = sm90::quad_sum(st.l[h] * f);
    r[h] = row_lo + 8 * h < seq_len ? 1.f / l : 0.f;
    c[h] = sm90::quad_sum(st.pe[h] * f) * r[h];
  }
  if (t4 == 0) {
    const size_t rc =
        (static_cast<size_t>(batch) * num_heads + head) * seq_len;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_lo + 8 * h;
      if (row < seq_len) {
        m_out[rc + row] = m[h];
        r_out[rc + row] = r[h];
        c_out[rc + row] = c[h];
      }
    }
  }

  float dqacc[NT][32];
  zero<NT>(dqacc);
  for (int kb = 0; kb < nkb; ++kb, ++n) {
    const int s = n % kStages;
    sm90::mbar_wait(&full[s], (n / kStages) & 1);
    const uint8_t* kv = ring + 2 * s * kHeadBytes;
    const int key0 = kb * kTile;
    if (kb + 1 < nkb) {
      dq_pass2<8, NT, false>(dqacc, q_s, do_s, kv, key0, seq_len, scale_log2,
                             m, r, c, t4);
    } else if (narrow) {
      dq_pass2<2, NT, true>(dqacc, q_s, do_s, kv, key0, seq_len, scale_log2,
                            m, r, c, t4);
    } else {
      dq_pass2<8, NT, true>(dqacc, q_s, do_s, kv, key0, seq_len, scale_log2,
                            m, r, c, t4);
    }
    sm90::mbar_arrive(&empty[s]);
  }
  const int tok_stride = num_heads * head_dim;
  __nv_bfloat16* out = dq + static_cast<size_t>(batch) * seq_len * tok_stride +
                       static_cast<size_t>(head) * head_dim;
  store_head<NT>(out, tok_stride, row_lo, seq_len, dqacc, scale, t4,
                 head_dim);
}

// One block of 8 kNT queries in (b) (q, d_o: its Q and dO tiles): S^T,
// dP^T, then dV += bf16(P^T) dO and dK += dS^T Q over the NC column tiles
// from c0. mrc: the block's m2, r, c, [64] f32 each.
template <int kNT, int NT, int NC>
__device__ __forceinline__ void dkdv_block(float (&dk)[NC][32],
                                           float (&dv)[NC][32],
                                           const uint8_t* k_s,
                                           const uint8_t* v_s,
                                           const uint8_t* q,
                                           const uint8_t* d_o, int c0,
                                           const float* mrc,
                                           float scale_log2, int t4) {
  float s[32], dp[32];
  scores_then_dp<kNT, NT, true>(s, dp, k_s, v_s, q, d_o);
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int col = nt * 8 + 2 * t4;
    const float2 m = *reinterpret_cast<const float2*>(mrc + col);
    const float2 r = *reinterpret_cast<const float2*>(mrc + kTile + col);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[4 * nt + i] =
          sm90::exp2_ftz(s[4 * nt + i] * scale_log2 - (i & 1 ? m.y : m.x)) *
          (i & 1 ? r.y : r.x);
    }
  }
  dp_landed<kNT>(dp);
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const float2 c =
        *reinterpret_cast<const float2*>(mrc + 2 * kTile + nt * 8 + 2 * t4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dp[4 * nt + i] = s[4 * nt + i] * (dp[4 * nt + i] - (i & 1 ? c.y : c.x));
    }
  }
  uint32_t pa[16], dsa[16];
  pack_tiles<kNT>(pa, s);
  pack_tiles<kNT>(dsa, dp);
  sm90::wgmma_fence();
  gemm_update<kNT, NC>(dv, pa, d_o + c0 * kTileBytes);
  gemm_update<kNT, NC>(dk, dsa, q + c0 * kTileBytes);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  fence_head<NC>(dv);
  fence_head<NC>(dk);
}

// kCols (NT > 2): blockIdx.x is twice the key tile plus the column half.
template <int NT>
__global__ void __launch_bounds__(kConsumers + 32, NT == 1 ? 2 : 1)
attn_unpacked_bwd_dkdv_sm90(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv,
                            const float* __restrict__ m_in,
                            const float* __restrict__ r_in,
                            const float* __restrict__ c_in, int seq_len,
                            int num_heads, int head_dim, float scale_log2,
                            float scale) {
  constexpr int kHeadBytes = NT * kTileBytes;
  constexpr bool kCols = NT > 2;
  constexpr int kOpBytes = (kCols ? kOpTiles : NT) * kTileBytes;
  constexpr int NC = kCols ? kColTiles : NT;  // accumulated column tiles
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align_tiles(smem_raw);
  uint8_t* k_s = smem;
  uint8_t* v_s = smem + kHeadBytes;
  uint8_t* ring = smem + 2 * kHeadBytes;  // stage s: Q at 2 s, dO at 2 s + 1
  float* mrc_s = reinterpret_cast<float*>(ring + 2 * kStages * kOpBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(mrc_s + kStages * 3 * kTile);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int kt = kCols ? blockIdx.x >> 1 : blockIdx.x;
  const int c0 = kCols ? (blockIdx.x & 1) * kColTiles : 0;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int nqb = (seq_len + kTile - 1) / kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  if (tid == kConsumers) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 32);  // every producer lane writes m, r, c
      sm90::mbar_init(&empty[s], kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // producer
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(kv_full, 2 * kHeadBytes);
      load_head<NT>(k_s, &tm_k, kv_full, head, kt * kTile, batch);
      load_head<NT>(v_s, &tm_v, kv_full, head, kt * kTile, batch);
    }
    const size_t rc =
        (static_cast<size_t>(batch) * num_heads + head) * seq_len;
    for (int qb = 0; qb < nqb; ++qb) {
      const int s = qb % kStages;
      if (qb >= kStages) sm90::mbar_wait(&empty[s], (qb / kStages - 1) & 1);
      // m2, r, c of the block's queries; past L, 0 each (so P is 0).
      float* mrc = mrc_s + s * 3 * kTile;
      for (int j = lane; j < kTile; j += 32) {
        const int qi = qb * kTile + j;
        const bool ok = qi < seq_len;
        mrc[j] = ok ? m_in[rc + qi] : 0.f;
        mrc[kTile + j] = ok ? r_in[rc + qi] : 0.f;
        mrc[2 * kTile + j] = ok ? c_in[rc + qi] : 0.f;
      }
      if (lane == 0) {
        uint8_t* st = ring + 2 * s * kOpBytes;
        sm90::mbar_arrive_expect_tx(&full[s], 2 * kHeadBytes);
        load_head<NT>(st, &tm_q, &full[s], head, qb * kTile, batch);
        load_head<NT>(st + kOpBytes, &tm_do, &full[s], head, qb * kTile,
                      batch);
      } else {
        sm90::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  const int t4 = lane & 3;
  // The last block: 16 wide when it holds at most 16 queries.
  const bool narrow = seq_len - (nqb - 1) * kTile <= kNarrow;
  sm90::mbar_wait(kv_full, 0);

  float dkacc[NC][32], dvacc[NC][32];
  zero<NC>(dkacc);
  zero<NC>(dvacc);
  for (int qb = 0; qb < nqb; ++qb) {
    const int s = qb % kStages;
    sm90::mbar_wait(&full[s], (qb / kStages) & 1);
    const uint8_t* qdo = ring + 2 * s * kOpBytes;
    const float* mrc = mrc_s + s * 3 * kTile;
    if (qb + 1 < nqb || !narrow) {
      dkdv_block<8, NT, NC>(dkacc, dvacc, k_s, v_s, qdo, qdo + kOpBytes, c0,
                            mrc, scale_log2, t4);
    } else {
      dkdv_block<2, NT, NC>(dkacc, dvacc, k_s, v_s, qdo, qdo + kOpBytes, c0,
                            mrc, scale_log2, t4);
    }
    sm90::mbar_arrive(&empty[s]);
  }
  const int tok_stride = num_heads * head_dim;
  const size_t base = static_cast<size_t>(batch) * seq_len * tok_stride +
                      static_cast<size_t>(head) * head_dim + c0 * 64;
  const int key_lo = kt * kTile + warp * 16 + (lane >> 2);
  store_head<NC>(dk + base, tok_stride, key_lo, seq_len, dkacc, scale, t4,
                 head_dim - c0 * 64);
  store_head<NC>(dv + base, tok_stride, key_lo, seq_len, dvacc, 1.f, t4,
                 head_dim - c0 * 64);
}

// Launches (a) and then (b) at NT tiles a head (stage -1, the backward),
// or one of them alone to time it (0: (a), 1: (b), which reads the m, r,
// c that (a) wrote).
template <int NT>
cudaError_t launch_nt(int stage, const CUtensorMap (&tm)[4], void* dq,
                      void* dk, void* dv, float* m, float* r, float* c,
                      int batch, int seq_len, int num_heads, int head_dim,
                      float scale, cudaStream_t s) {
  const float scale_log2 = scale * kLog2e;
  const dim3 grid((seq_len + kTile - 1) / kTile, num_heads, batch);
  cudaError_t err = cudaSuccess;
  if (stage != 1) {
    err = cudaFuncSetAttribute(attn_unpacked_bwd_dq_sm90<NT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dq_smem(NT)));
    if (err != cudaSuccess) return err;
    attn_unpacked_bwd_dq_sm90<NT><<<grid, kConsumers + 32, dq_smem(NT), s>>>(
        tm[0], tm[1], tm[2], tm[3], static_cast<__nv_bfloat16*>(dq), m, r, c,
        seq_len, num_heads, head_dim, scale_log2, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (stage != 0) {
    err = cudaFuncSetAttribute(attn_unpacked_bwd_dkdv_sm90<NT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dkdv_smem(NT)));
    if (err != cudaSuccess) return err;
    // At three or four tiles a head, each key tile's two column halves.
    const dim3 dkdv_grid((NT > 2 ? 2 : 1) * grid.x, num_heads, batch);
    attn_unpacked_bwd_dkdv_sm90<NT>
        <<<dkdv_grid, kConsumers + 32, dkdv_smem(NT), s>>>(
            tm[0], tm[1], tm[2], tm[3], static_cast<__nv_bfloat16*>(dk),
            static_cast<__nv_bfloat16*>(dv), m, r, c, seq_len, num_heads,
            head_dim, scale_log2, scale);
    err = cudaGetLastError();
  }
  return err;
}

int launch(int stage, const void* q, const void* k, const void* v,
           const void* dout, void* dq, void* dk, void* dv, void* m, void* r,
           void* c, int batch, int seq_len, int num_heads, int head_dim,
           float scale, int chunk_tiles, void* stream) {
  if (seq_len > kMaxLen || stage < -1 || stage > 1 || head_dim < 8 ||
      head_dim > kMaxHeadDim || head_dim % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tm[4];
  const void* src[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    if (!sm90_host::packed_head_map_d(&tm[i], src[i], batch, seq_len,
                                      num_heads, head_dim)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* mf = static_cast<float*>(m);
  auto* rf = static_cast<float*>(r);
  auto* cf = static_cast<float*>(c);
  if ((head_dim + 63) / 64 > 4) {
    const sm90::BwdArgs args{static_cast<__nv_bfloat16*>(dq),
                             static_cast<__nv_bfloat16*>(dk),
                             static_cast<__nv_bfloat16*>(dv),
                             mf, rf, cf, seq_len, num_heads, head_dim,
                             scale * kLog2e, scale, 0};
    return static_cast<int>(sm90_host::launch_attention_bwd_wide<true>(
        tm, args, batch, stage, chunk_tiles, s));
  }
  cudaError_t (*const by_tiles[4])(int, const CUtensorMap(&)[4], void*,
                                   void*, void*, float*, float*, float*,
                                   int, int, int, int, float,
                                   cudaStream_t) = {
      launch_nt<1>, launch_nt<2>, launch_nt<3>, launch_nt<4>};
  const cudaError_t err = by_tiles[(head_dim + 63) / 64 - 1](
      stage, tm, dq, dk, dv, mf, rf, cf, batch, seq_len, num_heads, head_dim,
      scale, s);
  return static_cast<int>(err);
}

}  // namespace

// Largest head dim the kernels take; any multiple of 8 up to it.
extern "C" int attention_unpacked_bwd_max_head_dim() { return kMaxHeadDim; }

extern "C" int attention_unpacked_bwd_max_len() { return kMaxLen; }

// q, k, v, dout, dq, dk, dv: [B, L, H, D] bf16, contiguous, 16-byte
// aligned; D a multiple of 8 up to 2,048. m, r, c: (B, H, L) f32 scratch
// that kernel (a) ((r) past four tiles a head) fills (m2, r, c of the
// header) and (b) reads. scale =
// D**-0.5 in f32. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// a head dim or a length past the limits or a tensor map that cannot be
// encoded.
extern "C" int attention_unpacked_bwd(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      void* dq, void* dk, void* dv, void* m,
                                      void* r, void* c, int batch,
                                      int seq_len, int num_heads,
                                      int head_dim, float scale,
                                      void* stream) {
  return launch(-1, q, k, v, dout, dq, dk, dv, m, r, c, batch, seq_len,
                num_heads, head_dim, scale, sm90::kBwdDqTiles, stream);
}

// attention_unpacked_bwd with at most `chunk_tiles` (from 1) of the
// outputs' 64-column tiles a CTA past head dim 256 (for tests: every chunk
// count gives the same bits).
extern "C" int attention_unpacked_bwd_chunked(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, void* m, void* r, void* c, int batch, int seq_len,
    int num_heads, int head_dim, float scale, int chunk_tiles,
    void* stream) {
  return launch(-1, q, k, v, dout, dq, dk, dv, m, r, c, batch, seq_len,
                num_heads, head_dim, scale, chunk_tiles, stream);
}

// One of the two kernels alone, to time it: `stage` 0 launches (a), 1 (b);
// (b) reads the m, r, c that (a) wrote. Past four tiles a head, stage 0
// is (r) and (a).
extern "C" int attention_unpacked_bwd_stage(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, void* m, void* r, void* c, int batch, int seq_len,
    int num_heads, int head_dim, float scale, int stage, void* stream) {
  return launch(stage, q, k, v, dout, dq, dk, dv, m, r, c, batch, seq_len,
                num_heads, head_dim, scale, sm90::kBwdDqTiles, stream);
}
