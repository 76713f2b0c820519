// The attention backwards at head dims past four 64-column tiles (256 < D
// <= 2,048; `heads=2` at width 768 is D = 384, `heads=1` 768), for Hopper
// (sm_90a): K4 (attention_packed_bwd.cu, kShift false: e = exp2 of the
// clamped log2-scaled score, no max) and K8 (attention_unpacked_bwd.cu,
// kShift true: the max-shift softmax). Their formulas and rounding points
// are the narrow kernels' (the files' headers):
//   K4: r = 1 / rowsum(e), c = rowsum(dP e) r, dS = bf16(e (dP - c)),
//       dQ = (dS K) (r scale), dK = dS^T bf16(Q r scale),
//       dV = bf16(e)^T bf16(dO r);
//   K8: m2, r, c = rowsum(dP P) of P = exp2(S scale log2(e) - m2) r,
//       dS = bf16(P (dP - c)), dQ = (dS K) scale, dK = (dS^T Q) scale,
//       dV = bf16(P)^T dO.
//
// Design. A head no longer fits: one 64-row tile of Q, K, V or dO is 96 KB
// at D = 768, 256 KB at 2,048, and the narrow kernels hold two of them and
// a ring of two more. So every operand streams through the pair ring of
// sm90.cuh (6 stages of 16 KB, two 64 x 64 tiles a stage, 4 loads ahead,
// one warpgroup a CTA, two CTAs an SM), and the two sides of the head
// part:
//  - the contractions over D, S = Q K^T and dP = dO V^T (S^T = K Q^T and
//    dP^T = V dO^T in (b)), are summed over the nd = ceil(D / 64) column
//    tiles in a loop of run-time length: the uses alternate tile c of Q
//    and K with tile c of dO and V, one commit group a use;
//  - the outputs' columns are split across CTAs: dQ kBwdDqTiles = 4 tiles
//    a CTA (128 accumulator registers), dK and dV kBwdDkdvTiles = 2 each
//    (128 together), the chunks of one tile neighbours in the grid so
//    that the re-read operands come from L2.
// Three kernels, so that each output element is summed by one accumulator
// in a fixed order (no atomics, the same bits launch to launch):
//  (r) attn_bwd_wide_rows, one CTA a 64-query tile: S and dP over all keys
//      once, the row statistics (K4: r, c; K8: m2, r, c) to the (B, H, L)
//      f32 scratch, as the narrow (a)'s first pass;
//  (a) attn_bwd_wide_dq, a CTA a (query tile, dQ chunk): S and dP again,
//      dS, and dQ += dS K over the chunk's tiles of K (two uses of two
//      tiles a key block);
//  (b) attn_bwd_wide_dkdv, a CTA a (key tile, dK/dV chunk): S^T and dP^T,
//      e^T (P^T) and dS^T from the query statistics, then the chunk's two
//      tiles of Q and of dO (K4 scales them in place, bf16(Q r scale) and
//      bf16(dO r), between the use's arrival and its product), dK += dS^T
//      Q and dV += e^T dO.
// Each chunk recomputes the contractions: S and dP once in (r), once a dQ
// chunk in (a) (2 at D = 384, 3 at 768, 8 at 2,048) and once a dK/dV chunk
// in (b) (3, 6, 16), against 2 and 1 (NT <= 2) in the narrow kernels. A
// chunk's columns are the same bits whatever the chunk count (the
// `_chunked` entry points store fewer tiles a CTA to show it). Shared
// memory 97 KB a CTA at every D; registers: (a) dQ 128, S and dP 64, dS
// 16; (b) dK and dV 128, S^T and dP^T 64, e and dS 32 (ptxas's report:
// the build log).

#pragma once

#include <math_constants.h>

#include "sm90_gemm.cuh"

namespace sm90 {

constexpr int kBwdDqTiles = 4;    // dQ's column tiles a CTA of (a)
constexpr int kBwdDkdvTiles = 2;  // dK's and dV's a CTA of (b)
constexpr float kBwdClamp = 80.f;

// A wide launch's scalars. m (K8 only), r, c: the (B, H, L) f32 row
// statistics that (r) writes and (a), (b) read. chunk_tiles: the output
// column tiles a CTA stores (at most kBwdDqTiles in (a), kBwdDkdvTiles in
// (b)).
struct BwdArgs {
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* m;
  float* r;
  float* c;
  int seq_len;
  int num_heads;
  int head_dim;
  float scale_log2;
  float scale;
  int chunk_tiles;
};

// K4's e of a raw score (0 where `valid` fails: a key or query past L).
__device__ __forceinline__ float bwd_clamped_e(float s, bool valid,
                                               float scale_log2) {
  return valid ? exp2f(fminf(fmaxf(s * scale_log2, -kBwdClamp), kBwdClamp))
               : 0.f;
}

// The CTA's ring, aligned shared memory and thread indices.
struct WideCta {
  uint8_t* smem;
  PairRing ring;
  int tid, warp, lane, g, t4;
};

__device__ __forceinline__ WideCta wide_cta(uint8_t* smem_raw) {
  uint8_t* smem = align_tiles(smem_raw);
  const int tid = threadIdx.x;
  return {smem, pair_ring(smem), tid, tid >> 5, tid & 31, (tid & 31) >> 2,
          tid & 3};
}

// Issues S (acc 0) or dP (acc 1) [+]= A B^T on a stage's two tiles.
__device__ __forceinline__ void gemm_pair(float (&d)[32], const uint8_t* st,
                                          bool acc) {
  gemm_nt(d, desc_k_major(st), desc_k_major(st + kTileBytes), acc);
}

// (r): per 64-query tile t, S and dP over every key block (uses 2 (j nd +
// c) and 2 (j nd + c) + 1: tile c of Q and K, of dO and V), then the rows'
// statistics.
template <bool kShift>
__global__ void __launch_bounds__(128, 2)
attn_bwd_wide_rows(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const BwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const WideCta w = wide_cta(smem_raw);
  const int seq_len = a.seq_len;
  const int nkb = (seq_len + kTileRows - 1) / kTileRows;
  const int nd = head_tiles(a.head_dim);
  const int t = blockIdx.x, head = blockIdx.y, batch = blockIdx.z;
  const int total = 2 * nkb * nd;
  auto load = [&](int n, int s, uint64_t* bar, bool issue) {
    const int j = n / (2 * nd);
    const int c = (n % (2 * nd)) >> 1;
    const bool odd = n & 1;
    pair_load(w.smem + s * kPairBytes, bar, odd ? &tm_do : &tm_q, c, head,
              t * kTileRows, odd ? &tm_v : &tm_k, c, head, j * kTileRows,
              batch, nd, issue && w.tid == 0);
  };
  if (w.tid == 0) {
    w.ring.init(4);
    fence_barrier_init();
    w.ring.prime(total, load);
  }
  __syncthreads();

  // Per lane and row h (g, g + 8). K4: the sums of e and of dP e; K8: the
  // running max of S2, the sums of e and dP e at it.
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f},
        pe[2] = {0.f, 0.f};
  for (int j = 0; j < nkb; ++j) {
    float s[32], dp[32];
    pair_products<2>(
        w.ring, w.smem, 2 * j * nd, nd, total, load,
        [&](int which, uint8_t* st, bool acc) {
          if (which == 0) {
            gemm_pair(s, st, acc);
          } else {
            gemm_pair(dp, st, acc);
          }
        },
        w.lane, false);
    fence(s);
    fence(dp);
    if constexpr (kShift) {
      float bm[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = j * kTileRows + (i >> 2) * 8 + 2 * w.t4 + (i & 1);
        const float x =
            key < seq_len ? s[i] * a.scale_log2 : -CUDART_INF_F;
        s[i] = x;
        bm[(i >> 1) & 1] = fmaxf(bm[(i >> 1) & 1], x);
      }
      float shift[2], alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float n = fmaxf(m[h], bm[h]);
        shift[h] = n == -CUDART_INF_F ? 0.f : n;  // no key yet: e = 0
        alpha[h] = exp2_ftz(m[h] - shift[h]);
        m[h] = n;
      }
      float le[2] = {0.f, 0.f}, pee[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        const float e = exp2_ftz(s[i] - shift[h]);
        le[h] += e;
        pee[h] += dp[i] * e;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] = l[h] * alpha[h] + le[h];
        pe[h] = pe[h] * alpha[h] + pee[h];
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = j * kTileRows + (i >> 2) * 8 + 2 * w.t4 + (i & 1);
        const float e = bwd_clamped_e(s[i], key < seq_len, a.scale_log2);
        l[(i >> 1) & 1] += e;
        pe[(i >> 1) & 1] += dp[i] * e;
      }
    }
  }
  const int row_lo = t * kTileRows + (w.warp & 3) * 16 + w.g;
  const size_t rc =
      (static_cast<size_t>(batch) * a.num_heads + head) * seq_len;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + 8 * h;
    float mm = 0.f, f = 1.f;
    if constexpr (kShift) {
      mm = quad_max(m[h]);
      f = exp2_ftz(m[h] - mm);  // a lane that saw only masked keys: 0
    }
    const float r = row < seq_len ? 1.f / quad_sum(l[h] * f) : 0.f;
    const float c = quad_sum(pe[h] * f) * r;
    if (w.t4 == 0 && row < seq_len) {
      if constexpr (kShift) a.m[rc + row] = mm;
      a.r[rc + row] = r;
      a.c[rc + row] = c;
    }
  }
}

// (a): query tile t's dQ columns tile0 .. tile0 + 3 (those below
// chunk_tiles stored). Key block j's uses: 2 nd pairs as (r)'s, then two
// of K's block j (the chunk's tiles, two a use).
template <bool kShift>
__global__ void __launch_bounds__(128, 2)
attn_bwd_wide_dq(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do,
                 const BwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const WideCta w = wide_cta(smem_raw);
  const int seq_len = a.seq_len;
  const int nkb = (seq_len + kTileRows - 1) / kTileRows;
  const int nd = head_tiles(a.head_dim);
  const int nch = (nd + a.chunk_tiles - 1) / a.chunk_tiles;
  const int t = blockIdx.x / nch;
  const int tile0 = (blockIdx.x % nch) * a.chunk_tiles;
  const int tile_end = tile0 + a.chunk_tiles;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int per = 2 * nd + 2;
  const int total = nkb * per;
  auto load = [&](int n, int s, uint64_t* bar, bool issue) {
    const int j = n / per;
    const int u = n % per;
    const bool pair = u < 2 * nd;
    const bool odd = u & 1;
    const int ck = tile0 + 2 * (u - 2 * nd);  // K's first tile of the use
    const CUtensorMap* ma = !pair ? &tm_k : odd ? &tm_do : &tm_q;
    pair_load(w.smem + s * kPairBytes, bar, ma,
              pair ? u >> 1 : ck < tile_end ? ck : nd, head,
              pair ? t * kTileRows : j * kTileRows,
              !pair ? &tm_k : odd ? &tm_v : &tm_k,
              pair ? u >> 1 : ck + 1 < tile_end ? ck + 1 : nd, head,
              j * kTileRows, batch, nd, issue && w.tid == 0);
  };
  if (w.tid == 0) {
    w.ring.init(4);
    fence_barrier_init();
    w.ring.prime(total, load);
  }
  __syncthreads();

  const int row_lo = t * kTileRows + (w.warp & 3) * 16 + w.g;
  const size_t rc =
      (static_cast<size_t>(batch) * a.num_heads + head) * seq_len;
  // The rows' statistics (0 past L: their dQ is not stored).
  float m[2], r[2], c[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = row_lo + 8 * h < seq_len;
    m[h] = ok && kShift ? a.m[rc + row_lo + 8 * h] : 0.f;
    r[h] = ok ? a.r[rc + row_lo + 8 * h] : 0.f;
    c[h] = ok ? a.c[rc + row_lo + 8 * h] : 0.f;
  }

  float dq[kBwdDqTiles][32];
  for (int j = 0; j < nkb; ++j) {
    const int n0 = j * per;
    float s[32], dp[32];
    pair_products<2>(
        w.ring, w.smem, n0, nd, total, load,
        [&](int which, uint8_t* st, bool acc) {
          if (which == 0) {
            gemm_pair(s, st, acc);
          } else {
            gemm_pair(dp, st, acc);
          }
        },
        w.lane, j > 0);
    fence(s);
    fence(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const int key = j * kTileRows + (i >> 2) * 8 + 2 * w.t4 + (i & 1);
      const float p =
          kShift ? (key < seq_len
                        ? exp2_ftz(s[i] * a.scale_log2 - m[h]) * r[h]
                        : 0.f)
                 : bwd_clamped_e(s[i], key < seq_len, a.scale_log2);
      dp[i] = p * (dp[i] - c[h]);
    }
    uint32_t ds[16];
    pack_a(ds, dp);
    const int nk = n0 + 2 * nd;
    w.ring.wait(nk, total, load);
    wgmma_fence();
    gemm_rn(dq[0], ds, desc_mn_major(pair_tile(w.smem, nk)), j > 0);
    gemm_rn(dq[1], ds, desc_mn_major(pair_tile(w.smem, nk) + kTileBytes),
            j > 0);
    wgmma_commit();
    w.ring.wait(nk + 1, total, load);
    wgmma_fence();
    gemm_rn(dq[2], ds, desc_mn_major(pair_tile(w.smem, nk + 1)), j > 0);
    gemm_rn(dq[3], ds,
            desc_mn_major(pair_tile(w.smem, nk + 1) + kTileBytes), j > 0);
    wgmma_commit();
    wgmma_wait<1>();
    w.ring.release(nk, w.lane);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < kBwdDqTiles; ++i) fence(dq[i]);
  w.ring.release(total - 1, w.lane);

  const int tok_stride = a.num_heads * a.head_dim;
  __nv_bfloat16* out = a.dq +
                       static_cast<size_t>(batch) * seq_len * tok_stride +
                       static_cast<size_t>(head) * a.head_dim;
#pragma unroll
  for (int i = 0; i < kBwdDqTiles; ++i) {
    if (i >= a.chunk_tiles) break;
    const int col0 = (tile0 + i) * 64;
    store_acc(out + col0, tok_stride, row_lo, seq_len, dq[i],
              kShift ? a.scale : r[0] * a.scale,
              kShift ? a.scale : r[1] * a.scale, w.t4, a.head_dim - col0);
  }
}

// (b): key tile kt's dK and dV columns tile0, tile0 + 1 (those below
// chunk_tiles stored). Query block qb's uses: 2 nd pairs (tile c of K and
// Q, of V and dO), then the chunk's tiles of Q, then of dO.
template <bool kShift>
__global__ void __launch_bounds__(128, 2)
attn_bwd_wide_dkdv(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const BwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const WideCta w = wide_cta(smem_raw);
  const int seq_len = a.seq_len;
  const int nqb = (seq_len + kTileRows - 1) / kTileRows;
  const int nd = head_tiles(a.head_dim);
  const int nch = (nd + a.chunk_tiles - 1) / a.chunk_tiles;
  const int kt = blockIdx.x / nch;
  const int tile0 = (blockIdx.x % nch) * a.chunk_tiles;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int per = 2 * nd + 2;
  const int total = nqb * per;
  auto load = [&](int n, int s, uint64_t* bar, bool issue) {
    const int qb = n / per;
    const int u = n % per;
    const bool pair = u < 2 * nd;
    const bool odd = u & 1;
    const CUtensorMap* mq = odd ? &tm_do : &tm_q;  // a chunk use's too
    pair_load(w.smem + s * kPairBytes, bar,
              !pair ? mq : odd ? &tm_v : &tm_k, pair ? u >> 1 : tile0, head,
              pair ? kt * kTileRows : qb * kTileRows, mq,
              pair ? u >> 1 : a.chunk_tiles > 1 ? tile0 + 1 : nd, head,
              qb * kTileRows, batch, nd, issue && w.tid == 0);
  };
  if (w.tid == 0) {
    w.ring.init(4);
    fence_barrier_init();
    w.ring.prime(total, load);
  }
  __syncthreads();

  const size_t rc =
      (static_cast<size_t>(batch) * a.num_heads + head) * seq_len;
  // K4: a chunk use's two tiles of Q (times r scale) or dO (times r) of
  // query block qb, in place, 16 bytes a thread at a time (a byte offset's
  // row is offset / 128 whatever the swizzle), then made visible to wgmma.
  auto scale_in_place = [&](uint8_t* st, int qb, float f) {
#pragma unroll
    for (int it = 0; it < kPairBytes / 16 / 128; ++it) {
      const int off = (w.tid + it * 128) * 16;
      const int q = qb * kTileRows + ((off % kTileBytes) >> 7);
      const float rr = (q < seq_len ? a.r[rc + q] : 0.f) * f;
      uint4 v = *reinterpret_cast<uint4*>(st + off);
      uint32_t* vw = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x =
            __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&vw[e]));
        vw[e] = pack_bf16(x.x * rr, x.y * rr);
      }
      *reinterpret_cast<uint4*>(st + off) = v;
    }
    fence_proxy_async();
    named_barrier<1>(128);
  };

  float dk[kBwdDkdvTiles][32], dv[kBwdDkdvTiles][32];
  for (int qb = 0; qb < nqb; ++qb) {
    const int n0 = qb * per;
    float s[32], dp[32];
    pair_products<2>(
        w.ring, w.smem, n0, nd, total, load,
        [&](int which, uint8_t* st, bool acc) {
          if (which == 0) {
            gemm_pair(s, st, acc);
          } else {
            gemm_pair(dp, st, acc);
          }
        },
        w.lane, qb > 0);
    fence(s);
    fence(dp);
    // Columns are queries: e^T (K4) or P^T (K8), and dS^T, with the
    // queries' statistics (0 past L, where e and P are 0).
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int q = qb * kTileRows + (i >> 2) * 8 + 2 * w.t4 + (i & 1);
      const bool ok = q < seq_len;
      const float cq = ok ? a.c[rc + q] : 0.f;
      float p;
      if constexpr (kShift) {
        const float mq = ok ? a.m[rc + q] : 0.f;
        const float rq = ok ? a.r[rc + q] : 0.f;
        p = exp2_ftz(s[i] * a.scale_log2 - mq) * rq;
      } else {
        p = bwd_clamped_e(s[i], ok, a.scale_log2);
      }
      s[i] = p;
      dp[i] = p * (dp[i] - cq);
    }
    uint32_t ea[16], dsa[16];
    pack_a(ea, s);
    pack_a(dsa, dp);
    const int nq = n0 + 2 * nd;
    w.ring.wait(nq, total, load);
    if constexpr (!kShift) scale_in_place(pair_tile(w.smem, nq), qb, a.scale);
    wgmma_fence();
    gemm_rn(dk[0], dsa, desc_mn_major(pair_tile(w.smem, nq)), qb > 0);
    gemm_rn(dk[1], dsa, desc_mn_major(pair_tile(w.smem, nq) + kTileBytes),
            qb > 0);
    wgmma_commit();
    w.ring.wait(nq + 1, total, load);
    if constexpr (!kShift) scale_in_place(pair_tile(w.smem, nq + 1), qb, 1.f);
    wgmma_fence();
    gemm_rn(dv[0], ea, desc_mn_major(pair_tile(w.smem, nq + 1)), qb > 0);
    gemm_rn(dv[1], ea, desc_mn_major(pair_tile(w.smem, nq + 1) + kTileBytes),
            qb > 0);
    wgmma_commit();
    wgmma_wait<1>();
    w.ring.release(nq, w.lane);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < kBwdDkdvTiles; ++i) {
    fence(dk[i]);
    fence(dv[i]);
  }
  w.ring.release(total - 1, w.lane);

  const int tok_stride = a.num_heads * a.head_dim;
  const size_t base = static_cast<size_t>(batch) * seq_len * tok_stride +
                      static_cast<size_t>(head) * a.head_dim;
  const int key_lo = kt * kTileRows + (w.warp & 3) * 16 + w.g;
  const float fk = kShift ? a.scale : 1.f;
#pragma unroll
  for (int i = 0; i < kBwdDkdvTiles; ++i) {
    if (i >= a.chunk_tiles) break;
    const int col0 = (tile0 + i) * 64;
    store_acc(a.dk + base + col0, tok_stride, key_lo, seq_len, dk[i], fk, fk,
              w.t4, a.head_dim - col0);
    store_acc(a.dv + base + col0, tok_stride, key_lo, seq_len, dv[i], 1.f,
              1.f, w.t4, a.head_dim - col0);
  }
}

}  // namespace sm90

namespace sm90_host {

// Launches the wide backward on four maps over (D, H, L, B): (r) and (a)
// where `stage` is not 1, (b) where it is not 0 (-1: all three; (b) reads
// the statistics (r) wrote). `chunk_tiles` caps the output column tiles a
// CTA (kBwdDqTiles in (a), kBwdDkdvTiles in (b) where larger). Returns the
// first cudaError_t, or cudaErrorInvalidValue for a chunk below 1.
template <bool kShift>
inline cudaError_t launch_attention_bwd_wide(const CUtensorMap (&tm)[4],
                                             sm90::BwdArgs a, int batch,
                                             int stage, int chunk_tiles,
                                             cudaStream_t s) {
  if (chunk_tiles < 1) return cudaErrorInvalidValue;
  const size_t smem = sm90::pair_ring_smem();
  const int tiles = (a.seq_len + sm90::kTileRows - 1) / sm90::kTileRows;
  const int nd = sm90::head_tiles(a.head_dim);
  // A kernel whose CTA takes `per_cta` column tiles of its output.
  auto run = [&](auto kernel, int per_cta) {
    a.chunk_tiles = per_cta;
    const int nch = (nd + per_cta - 1) / per_cta;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<dim3(nch * tiles, a.num_heads, batch), 128, smem, s>>>(
        tm[0], tm[1], tm[2], tm[3], a);
    return cudaGetLastError();
  };
  const auto cap = [&](int most) {
    return chunk_tiles < most ? chunk_tiles : most;
  };
  cudaError_t err = cudaSuccess;
  if (stage != 1) {
    err = run(sm90::attn_bwd_wide_rows<kShift>, nd);  // one CTA a tile
    if (err != cudaSuccess) return err;
    err = run(sm90::attn_bwd_wide_dq<kShift>, cap(sm90::kBwdDqTiles));
    if (err != cudaSuccess) return err;
  }
  if (stage != 0) {
    err = run(sm90::attn_bwd_wide_dkdv<kShift>, cap(sm90::kBwdDkdvTiles));
  }
  return err;
}

}  // namespace sm90_host
