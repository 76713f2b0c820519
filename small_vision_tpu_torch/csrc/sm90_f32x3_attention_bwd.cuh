// The f32 attention backwards for Hopper (sm_90a), their products on the
// TF32 tensor cores in three passes (3xTF32): K4's f32 instance
// (attention_packed_f32.cu) under the `ClampExp2` policy and K8's
// (attention_unpacked_f32.cu) under `MaxShift` (sm90_f32x3.cuh).
//
// Replaces, for f32 inputs: small_vision_tpu/ops/attention.py::
// _pallas_attention_packed_bwd_impl (`_attn_bwd_kernel_packed`) and
// _pallas_attention_bwd_impl (`_attn_bwd_kernel`). On rows of heads (B, L,
// H*D) (or [B, L, H, D], the same memory), per batch row and head, with
// scale2 = D**-0.5 log2(e), t = (q k^T) scale2 and e the policy's (exp2 of
// t clamped to +-80, or exp2(t - m) with m the row max of t; 0 for keys
// past L), formula by formula as the TPU kernels':
//   r = 1 / rowsum(e) (0 for queries past L); dV = e^T (dO r)
//   dP = dO v^T; c = rowsum(dP e) r; dS = e (dP - c)
//   dQ = (dS k) r scale; dK = dS^T (q r scale)
//
// The 3xTF32 products, their accumulators and the staging by cp.async are
// sm90_f32x3.cuh's (shared with the forward, sm90_f32x3_attention.cuh).
//
// Bound on this card: operations. The five products the backward needs
// are 10 B H L^2 D operations, 3x that on the TF32 tensor cores: 0.39 ms
// at (128, 257) with 12 heads of 64 at 495 TFLOP/s (0.97 ms at f32 FMA's
// 67); q, k, v, dO, dq, dk, dv are 28 B L H D bytes (0.056 ms at (128,
// 68), where the bytes bound). The kernels compute nine products, as the
// SIMT ones did: S and dP in each of three kernels, then dS K, and p^T dO
// and dS^T Q. What holds them far from the bound is staging, not the
// tensor cores: every operand is read from global memory as f32 and split
// into hi and lo tiles by the threads (in a first build, whose loads were
// synchronous, leaving the score products out barely shortened the
// statistics kernel; landing the loads asynchronously, behind the
// previous step's products, shortened all three kernels at every training
// shape).
//
// Design. Three kernels, each output element summed in a fixed order by
// one accumulator (no atomics: two launches give the same bits):
//  (r) stats, a CTA a 64-query tile: S and dP over every key chunk, the
//      row statistics r, c (and m) into (B, H, L) f32 scratch;
//  (a) dq, a CTA a (64-query tile, 64 columns of dQ): S and dP again, dS
//      split into shared memory, dQ += dS K;
//  (b) dkdv, a CTA a (64-key tile, 64 columns of dK and dV): S^T = K Q^T
//      and dP^T = V dO^T over every query chunk, p^T = e^T r and dS^T r
//      scale from the queries' statistics, then dV += p^T dO and dK +=
//      (dS^T r scale) Q.
// A CTA is one warpgroup, two CTAs an SM, and walks a fixed sequence of
// steps: per key (query) chunk, a score step for each 32-column chunk of
// D, then one (a) or two (b) product steps. A step's operands land as raw
// f32 rows by cp.async in a 32 KB landing area; the threads split them
// into the step's tiles, issue the next step's copies, and then run the
// step's wgmma, so each step's global reads are in flight behind the
// previous step's products. The operands whose contraction runs along L
// (K for dQ, dO for dV, Q for dK) are split transposed from their landed
// rows, and the score-side A operands (dS, p^T, dS^T) go from the
// accumulators through shared memory, split. Key and query chunks are
// `chunk_width(L)`. Shared memory: the score steps' four split tiles (16
// KB each) and the product steps' A and B operands (32 KB each) share 64
// KB, beside the 32 KB landing area and 1 KB of query statistics. A
// producer warpgroup filling a ring of stages through mbarriers was
// measured slower here: its consumer warpgroup spilled and ran the
// softmax between its own products, one CTA an SM. Head dims 1 to
// 2,048: the score products loop over D in 32-column chunks, and past 64
// columns the outputs' columns are split across CTAs (gridDim.y), each
// recomputing the scores.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90.cuh"
#include "sm90_f32x3.cuh"

namespace f32x3 {

// Shared memory, from the 1024-byte aligned base. A split tile is a hi
// tile and, kSub further, its lo tile, each up to 64 rows of 128 bytes.
// The score steps' four split tiles (A0, B0, A1, B1) and the product
// steps' A and B operands (64 rows by up to 64 contraction columns, as
// two 32-column sub-tiles t: hi at t kSub, lo at (2 + t) kSub) share the
// first 64 KB. The raw f32 rows of the next step land at kRaw, 32 KB: a
// score step's A0, B0, A1, B1 rows of 32 floats (8 KB each), or a product
// step's kN rows of 64 floats kRawStride apart. (b) keeps a query chunk's
// statistics (m, r, r scale, c) at kStats.
constexpr int kA0 = 0, kB0 = 2 * kSub, kA1 = 4 * kSub, kB1 = 6 * kSub;
constexpr int kProdA = 0, kProdB = 4 * kSub;
constexpr int kRaw = 8 * kSub;
constexpr int kRawStride = kCols + 4;  // floats; rows 4 banks apart
constexpr int kStats = kRaw + 4 * kSub;
constexpr size_t kSmemBytes = 1024 + kStats + 4 * kMaxN * sizeof(float);
static_assert(kMaxN * kRawStride * 4 <= 4 * kSub, "a product step's rows");
static_assert(2 * (kSmemBytes + 1024) <= 233472, "two CTAs an SM");

// ---- staging: raw rows by cp.async, then split in shared memory -----------

// kR raw rows of 32 floats at raw, split into the hi tile at dst and the lo
// tile kSub further, a raw row a tile row, 128-byte swizzled.
template <int kR>
__device__ __forceinline__ void split_rows(uint8_t* dst, const float* raw) {
#pragma unroll
  for (int it = 0; it < (kR * 8 + kThreads - 1) / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    if (kR * 8 % kThreads != 0 && idx >= kR * 8) break;
    const int r = idx / 8, c = 4 * (idx % 8);
    const float4 x = *reinterpret_cast<const float4*>(raw + r * 32 + c);
    float4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    const int off = swizzled(r, c);
    *reinterpret_cast<float4*>(dst + off) = h;
    *reinterpret_cast<float4*>(dst + kSub + off) = l;
  }
}

// kN raw rows of 64 floats (kRawStride apart) transposed and split into a
// product step's K-major B operand at dst: raw column j is tile row j and
// raw row i column i % 32 of sub-tile i / 32. Pairs of lanes read 32 bytes
// of a row; a store of 32 lanes covers two tile rows and 16 columns, free
// of bank conflicts.
template <int kN>
__device__ __forceinline__ void split_cols(uint8_t* dst, const float* raw) {
#pragma unroll
  for (int it = 0; it < kN * 16 / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int i = (idx / 2) % kN, j = 2 * (idx / (2 * kN)) + idx % 2;
    const float4 x =
        *reinterpret_cast<const float4*>(raw + i * kRawStride + 4 * j);
    const float v[4] = {x.x, x.y, x.z, x.w};
    uint8_t* hi = dst + (i / 32) * kSub;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int off = swizzled(4 * j + e, i % 32);
      float h, l;
      split(v[e], h, l);
      *reinterpret_cast<float*>(hi + off) = h;
      *reinterpret_cast<float*>(hi + 2 * kSub + off) = l;
    }
  }
}

// A warpgroup's 64 x kN accumulator x (wgmma's layout: this thread holds
// rows 16 w + g and + 8, columns 8 n + 2 t4 and + 1) split into the
// product steps' K-major A operand at dst, its kN columns the contraction.
template <int kN>
__device__ __forceinline__ void store_a(uint8_t* dst,
                                        const float (&x)[kN / 2]) {
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * (threadIdx.x / 32) + lane / 4, t4 = lane % 4;
#pragma unroll
  for (int n = 0; n < kN / 8; ++n) {
    const int c = 8 * n + 2 * t4;
    uint8_t* hi = dst + (c / 32) * kSub;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = swizzled(r0 + 8 * h, c % 32);
      float2 vh, vl;
      split(x[4 * n + 2 * h], vh.x, vl.x);
      split(x[4 * n + 2 * h + 1], vh.y, vl.y);
      *reinterpret_cast<float2*>(hi + off) = vh;
      *reinterpret_cast<float2*>(hi + 2 * kSub + off) = vl;
    }
  }
}

// ---- products -----------------------------------------------------------------

// acc (64 x 64) = A B^T over the product operands' kN contraction columns.
template <int kN>
__device__ __forceinline__ void operand_product(float (&acc)[32],
                                                const uint8_t* a,
                                                const uint8_t* b) {
#pragma unroll
  for (int ks = 0; ks < kN / 8; ++ks) {
    const int t = ks / 4;
    const uint64_t s = (ks % 4) * sm90::kKMajorStep;
    mma3<64>(acc, sm90::desc_k_major(a + t * kSub) + s,
             sm90::desc_k_major(a + (2 + t) * kSub) + s,
             sm90::desc_k_major(b + t * kSub) + s,
             sm90::desc_k_major(b + (2 + t) * kSub) + s, ks == 0);
  }
}

// ---- the steps ----------------------------------------------------------------

// What a CTA multiplies, per key (query) chunk j (rows [j kN, j kN + kN)):
// for each 32-column chunk c of D, a score step (rows [row0, row0 + 64)
// of a0 with the chunk's rows of b0, and of a1 with b1, columns [32 c, 32 c
// + 32)); then kProducts product steps (the chunk's rows of p0, then p1,
// columns [col0, col0 + 64), transposed). Step n of the CTA is step n %
// per of chunk n / per, per = nd + kProducts.
struct Plan {
  const float* a0;
  const float* b0;
  const float* a1;
  const float* b1;
  const float* p0;
  const float* p1;
  int row0;
  int col0;
  int nd;   // 32-column chunks of D
  int per;  // steps a chunk
};

// Issues (and commits) the copies of step n's raw rows into shared memory,
// if the CTA has a step n.
template <int kN>
__device__ __forceinline__ void issue_step(uint8_t* smem, const Plan& p,
                                           int n, int total, int len,
                                           int stride, int d, bool vec) {
  if (n < total) {
    const int j = n / p.per, u = n % p.per;
    float* raw = reinterpret_cast<float*>(smem + kRaw);
    // Rows ld floats apart from raw + off.
    auto rows = [raw](int off, int ld) {
      return [=](int r, int c) { return raw + off + r * ld + c; };
    };
    if (u < p.nd) {
      const int c0 = u * kChunkCols;
      copy_rows<kRows, kChunkCols>(rows(0, kChunkCols), p.a0, p.row0, len,
                                   stride, c0, d, vec);
      copy_rows<kN, kChunkCols>(rows(kRows * kChunkCols, kChunkCols), p.b0,
                                j * kN, len, stride, c0, d, vec);
      copy_rows<kRows, kChunkCols>(rows(2 * kRows * kChunkCols, kChunkCols),
                                   p.a1, p.row0, len, stride, c0, d, vec);
      copy_rows<kN, kChunkCols>(rows(3 * kRows * kChunkCols, kChunkCols),
                                p.b1, j * kN, len, stride, c0, d, vec);
    } else {
      copy_rows<kN, kCols>(rows(0, kRawStride), u == p.nd ? p.p0 : p.p1,
                           j * kN, len, stride, p.col0, d, vec);
    }
  }
  cp_async_commit();
}

// Waits for step n's raw rows (and for every thread to be done with the
// shared tiles), splits them into the tiles (split(raw, tiles)), makes the
// tiles visible to the tensor cores, and issues the copies of step n + 1,
// which land while step n's products run.
template <int kN, class Split>
__device__ __forceinline__ void begin_step(uint8_t* smem, const Plan& p,
                                           int n, int total, int len,
                                           int stride, int d, bool vec,
                                           Split&& split_into_tiles) {
  cp_async_wait_all();
  __syncthreads();
  split_into_tiles(reinterpret_cast<const float*>(smem + kRaw));
  sm90::fence_proxy_async();
  __syncthreads();
  issue_step<kN>(smem, p, n + 1, total, len, stride, d, vec);
}

// acc0 = A0 B0^T and acc1 = A1 B1^T over the head's nd 32-column chunks
// (steps n0 .. n0 + nd - 1), each chunk's products in a fresh accumulator,
// added in order.
template <int kN>
__device__ __forceinline__ void score_steps(uint8_t* smem, const Plan& p,
                                            int n0, int total, int len,
                                            int stride, int d, bool vec,
                                            float (&acc0)[kN / 2],
                                            float (&acc1)[kN / 2]) {
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc0[i] = acc1[i] = 0.f;
  for (int c = 0; c < p.nd; ++c) {
    begin_step<kN>(smem, p, n0 + c, total, len, stride, d, vec,
                   [&](const float* raw) {
                     split_rows<kRows>(smem + kA0, raw);
                     split_rows<kN>(smem + kB0, raw + kRows * kChunkCols);
                     split_rows<kRows>(smem + kA1,
                                       raw + 2 * kRows * kChunkCols);
                     split_rows<kN>(smem + kB1, raw + 3 * kRows * kChunkCols);
                   });
    float t0[kN / 2], t1[kN / 2];
    sm90::wgmma_fence();
    chunk_product<kN>(t0, smem + kA0, smem + kB0);
    chunk_product<kN>(t1, smem + kA1, smem + kB1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence(t0);
    sm90::fence(t1);
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      acc0[i] += t0[i];
      acc1[i] += t1[i];
    }
  }
}

// acc += x B over product step n: x (64 x kN) split into the A operand and
// the step's raw rows into the B operand, then the product in a fresh
// accumulator, added.
template <int kN>
__device__ __forceinline__ void product_step(uint8_t* smem, const Plan& p,
                                             int n, int total, int len,
                                             int stride, int d, bool vec,
                                             const float (&x)[kN / 2],
                                             float (&acc)[32]) {
  begin_step<kN>(smem, p, n, total, len, stride, d, vec,
                 [&](const float* raw) {
                   store_a<kN>(smem + kProdA, x);
                   split_cols<kN>(smem + kProdB, raw);
                 });
  float t[32];
  sm90::wgmma_fence();
  operand_product<kN>(t, smem + kProdA, smem + kProdB);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence(t);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += t[i];
}

// ---- kernels ------------------------------------------------------------------

// The scalars of a launch.
struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  float* dq;
  float* dk;
  float* dv;
  float* m;  // (B, H, L): MaxShift only (may be null under ClampExp2)
  float* r;
  float* c;
  int len;
  int heads;
  int d;
  float scale2;
  float scale;
  bool vec;  // 16-byte copies and 8-byte stores (see copy_rows)
};

// (r) Grid (query tiles, H, B).
template <class P, int kN>
__global__ void __launch_bounds__(kThreads, 2)
attn_f32x3_stats_kernel(const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align_tiles(smem_raw);
  const int lane = threadIdx.x % 32, t4 = lane % 4;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int stride = a.heads * a.d;
  const size_t base = static_cast<size_t>(blockIdx.z) * a.len * stride +
                      static_cast<size_t>(h) * a.d;
  const int nd = (a.d + kChunkCols - 1) / kChunkCols;
  const Plan p{a.q + base, a.k + base, a.dout + base, a.v + base, nullptr,
               nullptr, q0, 0, nd, nd};
  const int total = (a.len + kN - 1) / kN * p.per;
  issue_step<kN>(smem, p, 0, total, a.len, stride, a.d, a.vec);
  float m[2] = {-INFINITY, -INFINITY}, se[2] = {0.f, 0.f},
        sd[2] = {0.f, 0.f};
  for (int k0 = 0, n0 = 0; k0 < a.len; k0 += kN, n0 += p.per) {
    float s[kN / 2], dp[kN / 2];
    score_steps<kN>(smem, p, n0, total, a.len, stride, a.d, a.vec, s, dp);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (P::kShift) {
        float mt = -INFINITY;
#pragma unroll
        for (int n = 0; n < kN / 8; ++n) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (k0 + 8 * n + 2 * t4 + j < a.len) {
              mt = fmaxf(mt, s[4 * n + 2 * hh + j] * a.scale2);
            }
          }
        }
        const float m_new = fmaxf(m[hh], sm90::quad_max(mt));
        const float alpha = exp2f(m[hh] - m_new);
        m[hh] = m_new;
        se[hh] *= alpha;
        sd[hh] *= alpha;
      }
      float pe = 0.f, pd = 0.f;
#pragma unroll
      for (int n = 0; n < kN / 8; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = 4 * n + 2 * hh + j;
          const float e = k0 + 8 * n + 2 * t4 + j < a.len
                              ? P::e(s[i], a.scale2, m[hh])
                              : 0.f;
          pe += e;
          pd += dp[i] * e;
        }
      }
      se[hh] += sm90::quad_sum(pe);
      sd[hh] += sm90::quad_sum(pd);
    }
  }
  if (t4 != 0) return;
  const size_t stat0 = (static_cast<size_t>(blockIdx.z) * a.heads + h) * a.len;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + 16 * (threadIdx.x / 32) + lane / 4 + 8 * hh;
    if (row >= a.len) continue;
    const float r = 1.f / se[hh];
    a.r[stat0 + row] = r;
    a.c[stat0 + row] = sd[hh] * r;
    if (P::kShift) a.m[stat0 + row] = m[hh];
  }
}

// (a) Grid (query tiles, H * column chunks, B).
template <class P, int kN>
__global__ void __launch_bounds__(kThreads, 2)
attn_f32x3_dq_kernel(const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align_tiles(smem_raw);
  const int lane = threadIdx.x % 32, t4 = lane % 4;
  const int chunks = (a.d + kCols - 1) / kCols;
  const int h = blockIdx.y / chunks;
  const int col0 = (blockIdx.y % chunks) * kCols;
  const int q0 = blockIdx.x * kRows;
  const int stride = a.heads * a.d;
  const size_t base = static_cast<size_t>(blockIdx.z) * a.len * stride +
                      static_cast<size_t>(h) * a.d;
  const size_t stat0 = (static_cast<size_t>(blockIdx.z) * a.heads + h) * a.len;
  const int nd = (a.d + kChunkCols - 1) / kChunkCols;
  const Plan p{a.q + base, a.k + base, a.dout + base, a.v + base,
               a.k + base, nullptr, q0, col0, nd, nd + 1};
  const int total = (a.len + kN - 1) / kN * p.per;
  issue_step<kN>(smem, p, 0, total, a.len, stride, a.d, a.vec);
  float m[2], r[2], c[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + 16 * (threadIdx.x / 32) + lane / 4 + 8 * hh;
    const bool in = row < a.len;
    m[hh] = P::kShift && in ? a.m[stat0 + row] : 0.f;
    r[hh] = in ? a.r[stat0 + row] : 0.f;
    c[hh] = in ? a.c[stat0 + row] : 0.f;
  }
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int k0 = 0, n0 = 0; k0 < a.len; k0 += kN, n0 += p.per) {
    float s[kN / 2], dp[kN / 2];
    score_steps<kN>(smem, p, n0, total, a.len, stride, a.d, a.vec, s, dp);
    // dS = e (dP - c), in dp.
#pragma unroll
    for (int n = 0; n < kN / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool key = k0 + 8 * n + 2 * t4 + j < a.len;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * n + 2 * hh + j;
          const float e = key ? P::e(s[i], a.scale2, m[hh]) : 0.f;
          dp[i] = e * (dp[i] - c[hh]);
        }
      }
    }
    product_step<kN>(smem, p, n0 + nd, total, a.len, stride, a.d, a.vec, dp,
                     acc);
  }
  const float f[2] = {r[0] * a.scale, r[1] * a.scale};
  store_out(a.dq + base, stride, q0, a.len, col0, a.d, acc, f, a.vec);
}

// (b) Grid (key tiles, H * column chunks, B).
template <class P, int kN>
__global__ void __launch_bounds__(kThreads, 2)
attn_f32x3_dkdv_kernel(const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align_tiles(smem_raw);
  float* st_m = reinterpret_cast<float*>(smem + kStats);
  float* st_r = st_m + kMaxN;
  float* st_rs = st_r + kMaxN;
  float* st_c = st_rs + kMaxN;
  const int lane = threadIdx.x % 32, t4 = lane % 4;
  const int chunks = (a.d + kCols - 1) / kCols;
  const int h = blockIdx.y / chunks;
  const int col0 = (blockIdx.y % chunks) * kCols;
  const int key0 = blockIdx.x * kRows;
  const int stride = a.heads * a.d;
  const size_t base = static_cast<size_t>(blockIdx.z) * a.len * stride +
                      static_cast<size_t>(h) * a.d;
  const size_t stat0 = (static_cast<size_t>(blockIdx.z) * a.heads + h) * a.len;
  const int nd = (a.d + kChunkCols - 1) / kChunkCols;
  const Plan p{a.k + base, a.q + base, a.v + base, a.dout + base,
               a.dout + base, a.q + base, key0, col0, nd, nd + 2};
  const int total = (a.len + kN - 1) / kN * p.per;
  issue_step<kN>(smem, p, 0, total, a.len, stride, a.d, a.vec);
  bool key[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    key[hh] = key0 + 16 * (threadIdx.x / 32) + lane / 4 + 8 * hh < a.len;
  }
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  for (int q0 = 0, n0 = 0; q0 < a.len; q0 += kN, n0 += p.per) {
    // The chunk's query statistics (read after the score steps' barriers;
    // the last chunk's readers are past the barrier of its first product
    // step).
    if (threadIdx.x < kN) {
      const int row = q0 + threadIdx.x;
      const bool in = row < a.len;
      const float r = in ? a.r[stat0 + row] : 0.f;
      st_m[threadIdx.x] = P::kShift && in ? a.m[stat0 + row] : 0.f;
      st_r[threadIdx.x] = r;
      st_rs[threadIdx.x] = r * a.scale;
      st_c[threadIdx.x] = in ? a.c[stat0 + row] : 0.f;
    }
    float st[kN / 2], dpt[kN / 2];
    score_steps<kN>(smem, p, n0, total, a.len, stride, a.d, a.vec, st, dpt);
    // p^T = e^T r into st, dS^T r scale into dpt.
#pragma unroll
    for (int n = 0; n < kN / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 8 * n + 2 * t4 + j;
        const bool query = q0 + col < a.len;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * n + 2 * hh + j;
          const float e = key[hh] && query
                              ? P::e(st[i], a.scale2, st_m[col])
                              : 0.f;
          st[i] = e * st_r[col];
          dpt[i] = e * (dpt[i] - st_c[col]) * st_rs[col];
        }
      }
    }
    product_step<kN>(smem, p, n0 + nd, total, a.len, stride, a.d, a.vec, st,
                     dv);
    product_step<kN>(smem, p, n0 + nd + 1, total, a.len, stride, a.d, a.vec,
                     dpt, dk);
  }
  const float one[2] = {1.f, 1.f};
  store_out(a.dk + base, stride, key0, a.len, col0, a.d, dk, one, a.vec);
  store_out(a.dv + base, stride, key0, a.len, col0, a.d, dv, one, a.vec);
}

// ---- host -------------------------------------------------------------------

// Kernels of the backward: -1 all three in turn, or one of them
// (measurement).
enum BwdStage { kBwdAll = -1, kBwdStats = 0, kBwdDq = 1, kBwdDkdv = 2 };

template <class P, int kN>
int backward_n(const Args& a, int batch, int stage, cudaStream_t stream) {
  const int tiles = (a.len + kRows - 1) / kRows;
  const int chunks = (a.d + kCols - 1) / kCols;
  cudaError_t err = cudaSuccess;
  if (stage == kBwdAll || stage == kBwdStats) {
    err = launch_one(attn_f32x3_stats_kernel<P, kN>,
                     dim3(tiles, a.heads, batch), kSmemBytes, a, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (stage == kBwdAll || stage == kBwdDq) {
    err = launch_one(attn_f32x3_dq_kernel<P, kN>,
                     dim3(tiles, a.heads * chunks, batch), kSmemBytes, a,
                     stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (stage == kBwdAll || stage == kBwdDkdv) {
    err = launch_one(attn_f32x3_dkdv_kernel<P, kN>,
                     dim3(tiles, a.heads * chunks, batch), kSmemBytes, a,
                     stream);
  }
  return static_cast<int>(err);
}

// The backward's three kernels on `stream` (or the one `stage` names): the
// row statistics into m (MaxShift only; may be null under ClampExp2), r and
// c ((B, H, L) f32 scratch), dQ, and dK with dV, on (B, L, H*D) f32
// tensors. Returns cudaGetLastError() after each launch, or
// cudaErrorInvalidValue for a shape the kernels do not take.
template <class P>
int attn_backward(const float* q, const float* k, const float* v,
                  const float* dout, float* dq, float* dk, float* dv,
                  float* m, float* r, float* c, int batch, int len, int heads,
                  int d, float scale2, float scale, int stage,
                  cudaStream_t stream) {
  if (!attn_takes(batch, len, heads, d) || stage < kBwdAll ||
      stage > kBwdDkdv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = d % 4 == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v) && aligned16(dout) && aligned16(dq) &&
                   aligned16(dk) && aligned16(dv);
  const Args a{q, k, v, dout, dq, dk, dv, m, r, c, len, heads, d,
               scale2, scale, vec};
  switch (chunk_width(len)) {
    case 8: return backward_n<P, 8>(a, batch, stage, stream);
    case 16: return backward_n<P, 16>(a, batch, stage, stream);
    case 24: return backward_n<P, 24>(a, batch, stage, stream);
    case 32: return backward_n<P, 32>(a, batch, stage, stream);
    case 40: return backward_n<P, 40>(a, batch, stage, stream);
    case 48: return backward_n<P, 48>(a, batch, stage, stream);
    case 56: return backward_n<P, 56>(a, batch, stage, stream);
    case 64: return backward_n<P, 64>(a, batch, stage, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace f32x3
