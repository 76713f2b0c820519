// Bidirectional attention on packed (B, L, H*D) bf16 tensors, backward,
// for Hopper (sm_90a), at any head dim D that is a multiple of 8 up to
// 2,048.
//
// Replaces: small_vision_tpu/ops/attention.py::_attn_bwd_kernel_packed
// (reached via _pallas_attention_packed_bwd_impl, the custom VJP of
// fused_attention_packed). Per (batch, head), recomputing the forward's e:
//   e  = exp2(clamp(Q K^T * scale * log2(e), -80, 80)) * keymask   (f32)
//   r  = rowmask / rowsum(e)
//   dV = bf16(e)^T bf16(dO * r)
//   dP = dO V^T                                                     (f32)
//   c  = rowsum(dP * e) * r
//   dS = bf16(e * (dP - c))
//   dQ = (dS K) * (r * scale)
//   dK = dS^T bf16(Q * (r * scale))
// with f32 sums and bf16 outputs: the TPU kernel's formulas and its
// rounding points. The clamp is treated as the identity, as there: dS uses
// the clamped e and nothing is zeroed where the clamp bites.
//
// Bound on this card: at the training shapes (B=128, H=12, L up to 257,
// D=64) the 7*B*L*H*D*2 bytes of q, k, v, dO, dq, dk and dv (354 MB at
// L=257, 0.106 ms at 3.35 TB/s) outweigh the 5 products of 2*B*H*L^2*D
// flops (65 GFLOP, 0.066 ms at 989 TFLOP/s); the exp2 of every score is
// the next limit.
//
// Design. dK and dV contract over queries, while r and c need a whole row
// of keys first; the TPU kernel gets both by holding a whole head in VMEM.
// Here the work splits in two kernels, as in FlashAttention-2's backward,
// so that every output element is summed by one warpgroup's accumulator in
// a fixed order: no atomics, and two launches give the same bits.
//  (a) attn_bwd_dq: one CTA per (64-query tile, head, batch). Its consumer
//      warpgroup holds the tile's Q and dO; a producer warp streams the
//      head's 64-key blocks of K and V twice through a two-stage ring.
//      Pass 1 sums e and dP*e per row and stores r and c to the (B, H, L)
//      f32 scratch; pass 2 forms dS and accumulates dQ += dS K.
//  (b) attn_bwd_dkdv: one CTA per (64-key tile, head, batch). Its consumer
//      warpgroup holds the tile's K and V; the producer warp streams 64-query
//      blocks of Q and dO with their r and c through a two-stage ring. For
//      each block the consumers first round bf16(Q * r * scale) and
//      bf16(dO * r) into a second pair of tiles, then run S^T = K Q^T and
//      dP^T = V dO^T, form e^T and dS^T, and accumulate dV and dK.
// Every L x L product is a wgmma m64n64k16 (bf16 in, f32 accumulate) of one
// consumer warpgroup. S, dP, S^T and dP^T read both operands from shared
// memory, K-major. dQ += dS K, dV += e^T (dO r) and dK += dS^T (Q r s) take
// A from registers (the previous product's accumulator, packed to bf16: its
// layout is the A operand's) and B from the same row-major tile through the
// transpose-B bit. Tiles arrive by TMA (a 3-D map over (H*64, L, B), box
// (64, 64, 1), 128-byte swizzle), which reads the packed layout in place and
// fills rows at or past L with zeros, as the TPU kernel's select does;
// barriers are mbarriers. Outputs are stored from registers, rows < L only.
//
// What this does about the old kernel's costs: nothing is staged
// transposed (the old kernel wrote K^T and the two scaled operands 2 bytes
// at a time, 8-way bank conflicts); the scaled operands are made by a
// vectorised pass over a landed tile, 16 bytes a thread (the swizzle keeps
// each row within its 128 bytes, so a byte offset's row is offset / 128 and
// the result is written at the same offset, already swizzled for wgmma).
// That pass is chosen over having (a) write the scaled operands to device
// memory: it costs no scratch and no extra 2 x 50 MB written and read at
// L=257, and it is 16 multiplies a thread a block. Shared memory no longer
// grows with L: (a) 49 KB, (b) 82 KB, so three CTAs of (a) or two of (b)
// (each a consumer warpgroup and a producer warp) share an SM, with the
// next block's copy in flight during the current block's products. Products stay 9 L x L products a
// call (pass 1: S, dP; pass 2: S, dP, dS K; (b): S^T, dP^T, two updates) and
// three exp2 of each score: keeping e of a whole row between the passes
// would take 64 x 272 x 4 bytes of shared memory a tile, a third CTA's room.
//
// Registers: (b) holds four 64 x 64 f32 accumulators, S^T, dP^T, dV and
// dK (128 a thread), and the bf16 A operands e^T and dS^T (32). Two
// 160-thread CTAs of (b) an SM put at most three warps on each of the SM's
// four register files, 168 registers a thread; ptxas fits (b) in 168 and
// (a) in 122 with no spills, so (a) runs three CTAs an SM (128 a thread).
// With that room the consumers need no registers from the producer warp,
// and setmaxnreg is not used. Issuing block qb + 1's S^T and dP^T with block
// qb's updates would hold all four accumulators and both A operands in
// flight at once: ptxas spills at 168 and serialises the wgmmas, so (b)
// only makes the next block's scaled operands while the updates run.

// The ragged edge: every block is a whole 64-row tile, zero-filled past L,
// and its e masked to 0. At L=257 that is 5 blocks, 320 columns where 257
// are needed (272 with a narrower last block), 24 % more score products and
// exp2 than the work; at L=68, 2 blocks, 128 columns for 68.

// Head dims, as in the forward (attention_packed.cu): a head is NT = 1 to
// 4 tiles of 64 columns, read by TMA boxes of a (D, H, L, B) tensor map
// that arrive as zeros past D, so padded columns add 0 to every score and
// dP, and give 0 columns of dQ, dK and dV, which the stores drop. At NT =
// 2 every tile doubles: (a) 97 KB, two CTAs an SM; (b) 161 KB and the dK
// and dV accumulators 128 registers, one CTA an SM with up to 255 a thread.
//
// Wide heads, NT = 3 or 4 (128 < D <= 256: `heads=4` and `heads=3` at
// width 768). (a) fits as it is: 1 KB + 6 x NT x 8 KB (145 or 193 KB), one
// CTA an SM, its dQ accumulator 96 or 128 registers beside S and dP (64).
// (b) does not: its ring would take 2 x 4 x NT x 8 KB (192 or 256 KB) and
// its dK and dV accumulators 192 or 256 registers a thread. So at NT >= 3
// (b) becomes attn_bwd_dkdv_cols: the grid's first axis takes each key
// tile twice, and CTA half h accumulates only the column tiles 2 h and 2 h
// + 1 of dK and dV (kColTiles; 128 accumulator registers). Each half
// recomputes S^T and dP^T over all NT tiles of D (the contraction needs
// them; the two halves of a tile are neighbours in the grid, so Q and dO
// come from L2 the second time), and scales only its own two column tiles
// of Q and dO, in place in the stage (the S^T and dP^T products are done
// with them by then), so a stage is Q and dO only: 2 stages x 2 x 4 tiles,
// 194 KB (NT = 4; 178 KB at 3). At NT = 3 the stage's operands keep room
// for a fourth tile, which TMA never writes: the second half's products
// with it land in accumulator columns 192-255, which the store drops. The
// scaling now waits for the products instead of running beside the
// previous block's updates (a named barrier before the in-place writes,
// one after them). The arithmetic, its rounding points and the order of
// every sum are (b)'s: each output element still comes from one
// accumulator in a fixed order, no atomics, the same bits launch to launch.
// The kernels at NT <= 2 are unchanged.
//
// Past four tiles (256 < D <= 2,048: `heads=2` at width 768 is D = 384,
// `heads=1` 768) the head no longer fits a CTA, and the backward runs the
// wide kernels of sm90_attention_bwd.cuh (their design and costs there)
// under this file's softmax (kShift false): (r) the row statistics r and
// c, (a) dQ four column tiles a CTA, (b) dK and dV two each; every operand
// streams through a ring of 16 KB tile pairs, the contractions over D in a
// loop of run-time length, and each chunk recomputes S and dP. The
// formulas and rounding points are the ones above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_attention_bwd.cuh"

namespace {

constexpr int kMaxHeadDim = 2048;
constexpr int kTile = sm90::kTileRows;
constexpr int kTileBytes = sm90::kTileBytes;
constexpr int kStages = 2;
constexpr int kConsumers = 128;             // one warpgroup
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr float kClamp = 80.f;
// Longest sequence the kernels take. Shared memory does not grow with L;
// this is the longest length the card's tests hold the kernels at.
constexpr int kMaxLen = 4096;

// (a): Q, dO; kStages x (K, V); barriers. (b): K, V; kStages x (Q, dO,
// bf16(Q r s), bf16(dO r)); kStages x (r, c) [64] f32; barriers. Each
// operand is NT tiles. Plus 1 KB to align the tiles to 1024 bytes.
constexpr size_t dq_smem(int nt) {
  return 1024 + (2 + 2 * kStages) * nt * kTileBytes + 64;
}
constexpr size_t dkdv_smem(int nt) {
  return 1024 + (2 + 4 * kStages) * nt * kTileBytes +
         kStages * 2 * kTile * 4 + 64;
}
// Wide heads' (b), attn_bwd_dkdv_cols: K, V; kStages x (Q, dO), each of
// kOpTiles tiles; kStages x (r, c); barriers.
constexpr int kColTiles = 2;             // dK and dV column tiles a CTA
constexpr int kOpTiles = 2 * kColTiles;  // a stage's Q or dO buffer
constexpr size_t dkdv_cols_smem(int nt) {
  return 1024 + (2 * nt + 2 * kStages * kOpTiles) * kTileBytes +
         kStages * 2 * kTile * 4 + 64;
}
static_assert(dq_smem(4) <= 232448 && dkdv_cols_smem(4) <= 232448,
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

// S [+]= A B^T over a head's NT tiles of columns, both K-major.
template <int NT>
__device__ __forceinline__ void gemm_nt_head(float (&d)[32], const uint8_t* a,
                                             const uint8_t* b) {
#pragma unroll
  for (int c = 0; c < NT; ++c) {
    sm90::gemm_nt(d, sm90::desc_k_major(a + c * kTileBytes),
                  sm90::desc_k_major(b + c * kTileBytes), c > 0);
  }
}

// D[c] [+]= P B[c] for each of a head's NT tiles of columns, B MN-major.
template <int NT>
__device__ __forceinline__ void gemm_rn_head(float (&d)[NT][32],
                                             const uint32_t (&p)[16],
                                             const uint8_t* b,
                                             bool accumulate) {
#pragma unroll
  for (int c = 0; c < NT; ++c) {
    sm90::gemm_rn(d[c], p, sm90::desc_mn_major(b + c * kTileBytes),
                  accumulate);
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
                                           float f_lo, float f_hi, int t4,
                                           int head_dim) {
#pragma unroll
  for (int c = 0; c < NT; ++c) {
    sm90::store_acc(out + c * 64, ld, row, rows, d[c], f_lo, f_hi, t4,
                    head_dim - c * 64);
  }
}

__device__ __forceinline__ float exp2_clamped(float s, float scale_log2) {
  return exp2f(fminf(fmaxf(s * scale_log2, -kClamp), kClamp));
}

template <int NT>
__global__ void __launch_bounds__(kThreads, NT == 1 ? 3 : NT == 2 ? 2 : 1)
attn_bwd_dq(const __grid_constant__ CUtensorMap tm_q,
            const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v,
            const __grid_constant__ CUtensorMap tm_do,
            __nv_bfloat16* __restrict__ dq, float* __restrict__ r_out,
            float* __restrict__ c_out, int seq_len, int num_heads,
            int head_dim, float scale_log2, float scale) {
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
  const int row_hi = row_lo + 8;
  sm90::mbar_wait(qdo_full, 0);

  float sacc[32], pacc[32];
  // Pass 1: row sums of e and of dP * e.
  float s_lo = 0.f, s_hi = 0.f, pe_lo = 0.f, pe_hi = 0.f;
  int n = 0;
  for (int kb = 0; kb < nkb; ++kb, ++n) {
    const int s = n % kStages;
    sm90::mbar_wait(&full[s], (n / kStages) & 1);
    uint8_t* st = ring + 2 * s * kHeadBytes;
    sm90::wgmma_fence();
    gemm_nt_head<NT>(sacc, q_s, st);
    gemm_nt_head<NT>(pacc, do_s, st + kHeadBytes);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence(sacc);
    sm90::fence(pacc);
    sm90::mbar_arrive(&empty[s]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kb * kTile + nt * 8 + 2 * t4 + (i & 1);
        const float e =
            key < seq_len ? exp2_clamped(sacc[4 * nt + i], scale_log2) : 0.f;
        if (i < 2) {
          s_lo += e;
          pe_lo += pacc[4 * nt + i] * e;
        } else {
          s_hi += e;
          pe_hi += pacc[4 * nt + i] * e;
        }
      }
    }
  }
  s_lo = sm90::quad_sum(s_lo);
  s_hi = sm90::quad_sum(s_hi);
  pe_lo = sm90::quad_sum(pe_lo);
  pe_hi = sm90::quad_sum(pe_hi);
  const float r_lo = row_lo < seq_len ? 1.f / s_lo : 0.f;
  const float r_hi = row_hi < seq_len ? 1.f / s_hi : 0.f;
  const float c_lo = pe_lo * r_lo;
  const float c_hi = pe_hi * r_hi;
  if (t4 == 0) {
    const size_t rc =
        (static_cast<size_t>(batch) * num_heads + head) * seq_len;
    if (row_lo < seq_len) {
      r_out[rc + row_lo] = r_lo;
      c_out[rc + row_lo] = c_lo;
    }
    if (row_hi < seq_len) {
      r_out[rc + row_hi] = r_hi;
      c_out[rc + row_hi] = c_hi;
    }
  }

  // Pass 2: dS for each key block, then dQ += dS K. (Issuing block kb + 1's
  // S and dP with block kb's dQ product, one wait for both, measured slower:
  // ptxas serialises the wgmmas for want of registers at three CTAs an SM.)
  float dqacc[NT][32];
  for (int kb = 0; kb < nkb; ++kb, ++n) {
    const int s = n % kStages;
    sm90::mbar_wait(&full[s], (n / kStages) & 1);
    uint8_t* st = ring + 2 * s * kHeadBytes;
    sm90::wgmma_fence();
    gemm_nt_head<NT>(sacc, q_s, st);
    gemm_nt_head<NT>(pacc, do_s, st + kHeadBytes);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence(sacc);
    sm90::fence(pacc);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kb * kTile + nt * 8 + 2 * t4 + (i & 1);
        const float e =
            key < seq_len ? exp2_clamped(sacc[4 * nt + i], scale_log2) : 0.f;
        pacc[4 * nt + i] = e * (pacc[4 * nt + i] - (i < 2 ? c_lo : c_hi));
      }
    }
    uint32_t dsa[16];
    sm90::pack_a(dsa, pacc);
    sm90::wgmma_fence();
    gemm_rn_head<NT>(dqacc, dsa, st, kb > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence_head<NT>(dqacc);
    sm90::mbar_arrive(&empty[s]);
  }
  const int tok_stride = num_heads * head_dim;
  __nv_bfloat16* out = dq + static_cast<size_t>(batch) * seq_len * tok_stride +
                       head * head_dim;
  store_head<NT>(out, tok_stride, row_lo, seq_len, dqacc, r_lo * scale,
                 r_hi * scale, t4, head_dim);
}

template <int NT>
__global__ void __launch_bounds__(kThreads, NT == 1 ? 2 : 1)
attn_bwd_dkdv(const __grid_constant__ CUtensorMap tm_q,
              const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v,
              const __grid_constant__ CUtensorMap tm_do,
              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
              const float* __restrict__ r_in, const float* __restrict__ c_in,
              int seq_len, int num_heads, int head_dim, float scale_log2,
              float scale) {
  constexpr int kHeadBytes = NT * kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align_tiles(smem_raw);
  uint8_t* k_s = smem;
  uint8_t* v_s = smem + kHeadBytes;
  // Stage s: Q, dO, bf16(Q r s), bf16(dO r), each NT tiles, from tile
  // 4 s NT.
  uint8_t* ring = smem + 2 * kHeadBytes;
  float* rc_s = reinterpret_cast<float*>(ring + 4 * kStages * kHeadBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(rc_s + kStages * 2 * kTile);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int kt = blockIdx.x;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int nqb = (seq_len + kTile - 1) / kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  if (tid == kConsumers) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 32);  // every producer lane writes r and c
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
    const size_t rc = (static_cast<size_t>(batch) * num_heads + head) *
                      seq_len;
    for (int qb = 0; qb < nqb; ++qb) {
      const int s = qb % kStages;
      if (qb >= kStages) sm90::mbar_wait(&empty[s], (qb / kStages - 1) & 1);
      // r and c of the block's queries; 0 past L (their e is masked too).
      float* r_s = rc_s + s * 2 * kTile;
      for (int j = lane; j < kTile; j += 32) {
        const int qi = qb * kTile + j;
        r_s[j] = qi < seq_len ? r_in[rc + qi] : 0.f;
        r_s[kTile + j] = qi < seq_len ? c_in[rc + qi] : 0.f;
      }
      if (lane == 0) {
        uint8_t* st = ring + 4 * s * kHeadBytes;
        sm90::mbar_arrive_expect_tx(&full[s], 2 * kHeadBytes);
        load_head<NT>(st, &tm_q, &full[s], head, qb * kTile, batch);
        load_head<NT>(st + kHeadBytes, &tm_do, &full[s], head, qb * kTile,
                      batch);
      } else {
        sm90::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  const int g = lane >> 2;
  const int t4 = lane & 3;
  sm90::mbar_wait(kv_full, 0);

  // Per block: S^T = K Q^T and dP^T = V dO^T (keys x queries), then
  // dV += e^T bf16(dO r) and dK += dS^T bf16(Q r s). Block qb + 1's scaled
  // operands are made while block qb's updates run.
  float dkacc[NT][32], dvacc[NT][32];
  auto stage = [&](int qb) { return ring + 4 * (qb % kStages) * kHeadBytes; };
  // bf16(Q * (r * scale)) and bf16(dO * r) of block qb, 16 bytes at a time
  // (a byte offset's row is offset / 128 whatever the swizzle), then a
  // barrier so that the warpgroup's wgmma reads them.
  auto scale_operands = [&](int qb) {
    const uint8_t* q_st = stage(qb);
    const float* r_s = rc_s + (qb % kStages) * 2 * kTile;
#pragma unroll
    for (int it = 0; it < kHeadBytes / 16 / kConsumers; ++it) {
      const int off = (tid + it * kConsumers) * 16;
      const float rr = r_s[(off % kTileBytes) >> 7];
      const float rs = rr * scale;
      const uint4 qv = *reinterpret_cast<const uint4*>(q_st + off);
      const uint4 dv4 =
          *reinterpret_cast<const uint4*>(q_st + kHeadBytes + off);
      const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(&qv);
      const __nv_bfloat162* d2 =
          reinterpret_cast<const __nv_bfloat162*>(&dv4);
      uint4 qo, dvo;
      uint32_t* qw = reinterpret_cast<uint32_t*>(&qo);
      uint32_t* dw = reinterpret_cast<uint32_t*>(&dvo);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 qf = __bfloat1622float2(q2[e]);
        const float2 df = __bfloat1622float2(d2[e]);
        qw[e] = sm90::pack_bf16(qf.x * rs, qf.y * rs);
        dw[e] = sm90::pack_bf16(df.x * rr, df.y * rr);
      }
      *reinterpret_cast<uint4*>(stage(qb) + 2 * kHeadBytes + off) = qo;
      *reinterpret_cast<uint4*>(stage(qb) + 3 * kHeadBytes + off) = dvo;
    }
    sm90::fence_proxy_async();
    sm90::named_barrier<1>(kConsumers);
  };

  sm90::mbar_wait(&full[0], 0);
  scale_operands(0);
  for (int qb = 0; qb < nqb; ++qb) {
    uint8_t* st = stage(qb);
    const float* c_s = rc_s + (qb % kStages) * 2 * kTile + kTile;
    float sacc[32], pacc[32];
    sm90::wgmma_fence();
    gemm_nt_head<NT>(sacc, k_s, st);
    gemm_nt_head<NT>(pacc, v_s, st + kHeadBytes);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence(sacc);
    sm90::fence(pacc);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = nt * 8 + 2 * t4 + (i & 1);
        const float e = qb * kTile + col < seq_len
                            ? exp2_clamped(sacc[4 * nt + i], scale_log2)
                            : 0.f;
        sacc[4 * nt + i] = e;
        pacc[4 * nt + i] = e * (pacc[4 * nt + i] - c_s[col]);
      }
    }
    uint32_t ea[16], dsa[16];
    sm90::pack_a(ea, sacc);
    sm90::pack_a(dsa, pacc);
    sm90::wgmma_fence();
    gemm_rn_head<NT>(dvacc, ea, st + 3 * kHeadBytes, qb > 0);
    gemm_rn_head<NT>(dkacc, dsa, st + 2 * kHeadBytes, qb > 0);
    sm90::wgmma_commit();
    if (qb + 1 < nqb) {
      sm90::mbar_wait(&full[(qb + 1) % kStages], ((qb + 1) / kStages) & 1);
      scale_operands(qb + 1);
    }
    sm90::wgmma_wait<0>();
    fence_head<NT>(dvacc);
    fence_head<NT>(dkacc);
    sm90::mbar_arrive(&empty[qb % kStages]);
  }
  const int tok_stride = num_heads * head_dim;
  const size_t base = static_cast<size_t>(batch) * seq_len * tok_stride +
                      head * head_dim;
  const int key_lo = kt * kTile + warp * 16 + g;
  store_head<NT>(dk + base, tok_stride, key_lo, seq_len, dkacc, 1.f, 1.f, t4,
                 head_dim);
  store_head<NT>(dv + base, tok_stride, key_lo, seq_len, dvacc, 1.f, 1.f, t4,
                 head_dim);
}

// (b) at three or four tiles a head: as attn_bwd_dkdv, for the column
// tiles c0 = 2 (blockIdx.x & 1) and c0 + 1 of dK and dV of key tile
// blockIdx.x / 2 (see the header), Q and dO scaled in place.
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkdv_cols(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv,
                   const float* __restrict__ r_in,
                   const float* __restrict__ c_in, int seq_len,
                   int num_heads, int head_dim, float scale_log2,
                   float scale) {
  constexpr int kHeadBytes = NT * kTileBytes;
  constexpr int kOpBytes = kOpTiles * kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align_tiles(smem_raw);
  uint8_t* k_s = smem;
  uint8_t* v_s = smem + kHeadBytes;
  // Stage s: Q at 2 s kOpBytes, dO kOpBytes further.
  uint8_t* ring = smem + 2 * kHeadBytes;
  float* rc_s = reinterpret_cast<float*>(ring + 2 * kStages * kOpBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(rc_s + kStages * 2 * kTile);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int kt = blockIdx.x >> 1;
  const int c0 = (blockIdx.x & 1) * kColTiles;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int nqb = (seq_len + kTile - 1) / kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  if (tid == kConsumers) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 32);  // every producer lane writes r and c
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
    const size_t rc = (static_cast<size_t>(batch) * num_heads + head) *
                      seq_len;
    for (int qb = 0; qb < nqb; ++qb) {
      const int s = qb % kStages;
      if (qb >= kStages) sm90::mbar_wait(&empty[s], (qb / kStages - 1) & 1);
      float* r_s = rc_s + s * 2 * kTile;
      for (int j = lane; j < kTile; j += 32) {
        const int qi = qb * kTile + j;
        r_s[j] = qi < seq_len ? r_in[rc + qi] : 0.f;
        r_s[kTile + j] = qi < seq_len ? c_in[rc + qi] : 0.f;
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

  const int g = lane >> 2;
  const int t4 = lane & 3;
  sm90::mbar_wait(kv_full, 0);

  float dkacc[kColTiles][32], dvacc[kColTiles][32];
  for (int qb = 0; qb < nqb; ++qb) {
    const int s = qb % kStages;
    sm90::mbar_wait(&full[s], (qb / kStages) & 1);
    uint8_t* st = ring + 2 * s * kOpBytes;
    const float* r_s = rc_s + s * 2 * kTile;
    const float* c_s = r_s + kTile;
    float sacc[32], pacc[32];
    sm90::wgmma_fence();
    gemm_nt_head<NT>(sacc, k_s, st);
    gemm_nt_head<NT>(pacc, v_s, st + kOpBytes);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence(sacc);
    sm90::fence(pacc);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = nt * 8 + 2 * t4 + (i & 1);
        const float e = qb * kTile + col < seq_len
                            ? exp2_clamped(sacc[4 * nt + i], scale_log2)
                            : 0.f;
        sacc[4 * nt + i] = e;
        pacc[4 * nt + i] = e * (pacc[4 * nt + i] - c_s[col]);
      }
    }
    uint32_t ea[16], dsa[16];
    sm90::pack_a(ea, sacc);
    sm90::pack_a(dsa, pacc);
    // Every warp's S^T and dP^T products are done with Q and dO: scale
    // this CTA's column tiles of them in place, bf16(Q * (r * scale)) and
    // bf16(dO * r), 16 bytes at a time (a byte offset's row is offset /
    // 128 whatever the swizzle).
    sm90::named_barrier<1>(kConsumers);
#pragma unroll
    for (int it = 0; it < kColTiles * kTileBytes / 16 / kConsumers; ++it) {
      const int off = c0 * kTileBytes + (tid + it * kConsumers) * 16;
      const float rr = r_s[(off % kTileBytes) >> 7];
      const float rs = rr * scale;
      uint4* qp = reinterpret_cast<uint4*>(st + off);
      uint4* dp = reinterpret_cast<uint4*>(st + kOpBytes + off);
      uint4 qv = *qp, dv4 = *dp;
      uint32_t* qw = reinterpret_cast<uint32_t*>(&qv);
      uint32_t* dw = reinterpret_cast<uint32_t*>(&dv4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 qf =
            __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&qw[e]));
        const float2 df =
            __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&dw[e]));
        qw[e] = sm90::pack_bf16(qf.x * rs, qf.y * rs);
        dw[e] = sm90::pack_bf16(df.x * rr, df.y * rr);
      }
      *qp = qv;
      *dp = dv4;
    }
    sm90::fence_proxy_async();
    sm90::named_barrier<1>(kConsumers);
    sm90::wgmma_fence();
    gemm_rn_head<kColTiles>(dvacc, ea, st + kOpBytes + c0 * kTileBytes,
                            qb > 0);
    gemm_rn_head<kColTiles>(dkacc, dsa, st + c0 * kTileBytes, qb > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence_head<kColTiles>(dvacc);
    fence_head<kColTiles>(dkacc);
    sm90::mbar_arrive(&empty[s]);
  }
  const int tok_stride = num_heads * head_dim;
  const size_t base = static_cast<size_t>(batch) * seq_len * tok_stride +
                      head * head_dim + c0 * 64;
  const int key_lo = kt * kTile + warp * 16 + g;
  store_head<kColTiles>(dk + base, tok_stride, key_lo, seq_len, dkacc, 1.f,
                        1.f, t4, head_dim - c0 * 64);
  store_head<kColTiles>(dv + base, tok_stride, key_lo, seq_len, dvacc, 1.f,
                        1.f, t4, head_dim - c0 * 64);
}

// (b) at NT tiles a head over `tiles` key tiles (each `ctas` times).
template <class Kernel>
cudaError_t launch_dkdv(Kernel kernel, size_t smem, int ctas,
                        const CUtensorMap& tq, const CUtensorMap& tk,
                        const CUtensorMap& tv, const CUtensorMap& tdo,
                        void* dk, void* dv, float* r, float* c, int batch,
                        int seq_len, int num_heads, int head_dim,
                        float scale_log2, float scale, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(ctas * ((seq_len + kTile - 1) / kTile), num_heads, batch);
  kernel<<<grid, kThreads, smem, s>>>(
      tq, tk, tv, tdo, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), r, c, seq_len, num_heads, head_dim,
      scale_log2, scale);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const CUtensorMap& tdo, void* dq,
                   void* dk, void* dv, float* r, float* c, int batch,
                   int seq_len, int num_heads, int head_dim,
                   float scale_log2, float scale, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dq_smem(NT)));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq_len + kTile - 1) / kTile, num_heads, batch);
  attn_bwd_dq<NT><<<grid, kThreads, dq_smem(NT), s>>>(
      tq, tk, tv, tdo, static_cast<__nv_bfloat16*>(dq), r, c, seq_len,
      num_heads, head_dim, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // (b): at three or four tiles a head, the column halves of each key tile.
  if constexpr (NT > 2) {
    return launch_dkdv(attn_bwd_dkdv_cols<NT>, dkdv_cols_smem(NT), 2, tq, tk,
                       tv, tdo, dk, dv, r, c, batch, seq_len, num_heads,
                       head_dim, scale_log2, scale, s);
  } else {
    return launch_dkdv(attn_bwd_dkdv<NT>, dkdv_smem(NT), 1, tq, tk, tv, tdo,
                       dk, dv, r, c, batch, seq_len, num_heads, head_dim,
                       scale_log2, scale, s);
  }
}

}  // namespace

extern "C" int attention_packed_bwd_max_len() { return kMaxLen; }

// Largest head dim the kernels take; any multiple of 8 up to it.
extern "C" int attention_packed_bwd_max_head_dim() { return kMaxHeadDim; }

namespace {

int run(const void* q, const void* k, const void* v, const void* dout,
        void* dq, void* dk, void* dv, void* r, void* c, int batch,
        int seq_len, int num_heads, int head_dim, float scale_log2,
        float scale, int chunk_tiles, void* stream) {
  if (seq_len > kMaxLen || head_dim < 8 || head_dim > kMaxHeadDim ||
      head_dim % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tq, tk, tv, tdo;
  if (!sm90_host::packed_head_map_d(&tq, q, batch, seq_len, num_heads,
                                    head_dim) ||
      !sm90_host::packed_head_map_d(&tk, k, batch, seq_len, num_heads,
                                    head_dim) ||
      !sm90_host::packed_head_map_d(&tv, v, batch, seq_len, num_heads,
                                    head_dim) ||
      !sm90_host::packed_head_map_d(&tdo, dout, batch, seq_len, num_heads,
                                    head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* rf = static_cast<float*>(r);
  auto* cf = static_cast<float*>(c);
  if ((head_dim + 63) / 64 > 4) {
    const CUtensorMap tm[4] = {tq, tk, tv, tdo};
    const sm90::BwdArgs args{static_cast<__nv_bfloat16*>(dq),
                             static_cast<__nv_bfloat16*>(dk),
                             static_cast<__nv_bfloat16*>(dv),
                             nullptr, rf, cf, seq_len, num_heads, head_dim,
                             scale_log2, scale, 0};
    return static_cast<int>(sm90_host::launch_attention_bwd_wide<false>(
        tm, args, batch, -1, chunk_tiles, s));
  }
  cudaError_t (*const by_tiles[4])(
      const CUtensorMap&, const CUtensorMap&, const CUtensorMap&,
      const CUtensorMap&, void*, void*, void*, float*, float*, int, int, int,
      int, float, float, cudaStream_t) = {launch<1>, launch<2>, launch<3>,
                                          launch<4>};
  const cudaError_t err = by_tiles[(head_dim + 63) / 64 - 1](
      tq, tk, tv, tdo, dq, dk, dv, rf, cf, batch, seq_len, num_heads,
      head_dim, scale_log2, scale, s);
  return static_cast<int>(err);
}

}  // namespace

// q, k, v, dout, dq, dk, dv: (B, L, H*head_dim) bf16, contiguous, 16-byte
// aligned; head_dim a multiple of 8 up to 2,048. r, c: (B, H, L) f32
// scratch that kernel (a) fills ((r) past four tiles a head) and (b)
// reads. scale_log2 = head_dim**-0.5 * log2(e) and scale = head_dim**-0.5,
// in f32. Returns cudaGetLastError(), or cudaErrorInvalidValue for a head
// dim or length past the limits or a tensor map that cannot be encoded.
extern "C" int attention_packed_bwd(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    void* dq, void* dk, void* dv, void* r,
                                    void* c, int batch, int seq_len,
                                    int num_heads, int head_dim,
                                    float scale_log2, float scale,
                                    void* stream) {
  return run(q, k, v, dout, dq, dk, dv, r, c, batch, seq_len, num_heads,
             head_dim, scale_log2, scale, sm90::kBwdDqTiles, stream);
}

// attention_packed_bwd with at most `chunk_tiles` (from 1) of the outputs'
// 64-column tiles a CTA past head dim 256 (for tests: every chunk count
// gives the same bits).
extern "C" int attention_packed_bwd_chunked(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, void* r, void* c, int batch, int seq_len,
    int num_heads, int head_dim, float scale_log2, float scale,
    int chunk_tiles, void* stream) {
  return run(q, k, v, dout, dq, dk, dv, r, c, batch, seq_len, num_heads,
             head_dim, scale_log2, scale, chunk_tiles, stream);
}
