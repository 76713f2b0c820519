// The f32 attention forward for Hopper (sm_90a), its two products on the
// TF32 tensor cores (sm90_f32x3.cuh): K3's f32 instance
// (attention_packed_f32.cu) under the `ClampExp2` policy and K7's
// (attention_unpacked_f32.cu) under `MaxShift`.
//
// Replaces, for f32 inputs: small_vision_tpu/ops/attention.py::
// pallas_attention_packed (`_attn_kernel_packed`) and pallas_attention
// (`_attn_kernel`). On rows of heads (B, L, H*D) (or [B, L, H, D], the
// same memory), read in place, per batch row and head, with scale2 =
// D**-0.5 log2(e):
//   t = (q k^T) scale2
//   ClampExp2: e = exp2(clamp(t, -80, 80))       (no max: the clamp bounds e)
//   MaxShift:  e = exp2(t - m), m = the row max of t over the valid keys
//   e = 0 for keys past L; o = (e v) / rowsum(e)
//
// The scores, to better than f32. Under MaxShift e is exp2 of a
// difference t - m of scores in the thousands when q and k are large, and
// an f32 score is off by half its ulp there (2^-10 at 3e4): e moves by
// 1e-4 and so may o, where two keys nearly tie. So S = Q K^T is taken as
// an unevaluated pair hi + lo, its error far below the ulp of an f32 score:
//  - Each row of Q and of K (32 columns of D, a score step's) is split on
//    a grid of its own: part 0 is x rounded to a multiple of 2^(E - 7),
//    2^E the power of two at or below the row's largest |x| (9 bits at
//    most, a tf32 value); the rest x - part 0 (exact in f32, at most
//    2^(E - 8)) is split as 3xTF32 splits, into parts 1 and 2
//    (`split_row`).
//  - big = the sum of q0 k0 over the 32 columns is exact: |part 0| is at
//    most 2^8 units, a product a multiple of the two rows' units times at
//    most 2^16, the sum at most 2^21 of them: it fits f32's 24 bits, so
//    the tensor core's adds round nothing.
//  - small = q0 k2 + q2 k0 + q1 k1 + q0 k1 + q1 k0 (at most 2^-7 of 2^(Eq
//    + Ek) each; the dropped q1 k2 and q2 k1 at most 2^-28, and what parts
//    1 and 2 leave of the rest 2^-32 of 2^E) in an f32 accumulator, lo,
//    whose rounding is about 2^-7 of an f32 score's.
//  - Over the 32-column steps of a key chunk, lo accumulates small on the
//    tensor core, and hi takes big by a two-sum whose rounding error goes
//    to lo. t - m is fma(hi, scale2, -m) + lo scale2: one rounding of a
//    number near 0 where the key nearly ties the max.
// Six TF32 products a score step where 3xTF32 takes three. The e V
// product is 3xTF32 (e in [0, 1]: its error is that of f32 sums).
//
// Bound on this card: operations. The two products are 4 B H L^2 D
// operations; taken as six TF32 passes (S) and three (e V) they are 18 B H
// L^2 D on the TF32 tensor cores: 0.121 ms at the sampler's (64, 260) with
// 12 heads of 64 at 495 TFLOP/s, 0.236 ms at (128, 257); q, k, v and o are
// 16 B L H D bytes, which bound at (128, 68) (0.032 ms).
//
// Design. A CTA is one warpgroup, two CTAs an SM, and owns 64 query rows
// of one (b, h) and 64 of its output columns (gridDim.y: past 64 columns
// the columns are split across CTAs, each recomputing the scores). It walks
// the keys in chunks of N = chunk_width(L) (40 at L = 68, 56 at 164, 257
// and 260). Per chunk: S = Q K^T in score steps of 32 columns of D (big
// in a fresh accumulator each step, lo in one a chunk); e from the policy
// (under MaxShift a running row max, the sums and o rescaled when it
// grows); then e V in a fresh accumulator, added to o. Every sum runs in
// a fixed order and there are no atomics: two launches give the same
// bits.
//  - Each score step lands Q's and K's 32 columns by cp.async straight
//    into the first part of their tiles (swizzled), and each thread splits
//    one row in place (Q's 64 rows and K's N take a thread each).
//  - e goes from the score accumulator to wgmma's A registers, split in
//    registers: the A fragment holds columns t4 and t4 + 4 of a k8 step
//    where the accumulator holds 2 t4 and 2 t4 + 1, so V^T's keys are
//    stored in that order (`key_column`), which gives the same contraction.
//  - V lands as raw rows (its contraction runs along L, and TF32 wgmma
//    reads K-major operands only), split transposed into V^T while the
//    last score step's products run.
//  - The next step's Q and K rows are issued once the score products are
//    done; after a chunk's last step they go with the next chunk's V rows
//    and land behind the softmax and the e V products.
// Registers: hi, lo, big and o are 3 N / 2 + 32 a thread; ptxas puts the
// kernel at 255 with no spill at N = 56 (chip_smoke.py's `[build]`
// lines), and a split row is read twice rather than held.
// Shared memory: Q and K as three-part tiles (24 KB each), V^T as two
// split tiles (32 KB) and V's raw rows (16 KB), 97 KB with the alignment
// slack: two CTAs an SM.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90.cuh"
#include "sm90_f32x3.cuh"

namespace f32x3 {

// Bits of a row's grid below its largest power of two (`split_row`).
constexpr int kGridBits = 7;

// Shared memory of the forward, from the 1024-byte aligned base: Q's
// three-part tile (64 query rows by a score step's 32 columns; part p at p
// kSub), K's (N key rows), V^T's pair of split tiles (64 output-column
// rows by 32 keys each: tile t's hi at 2 t kSub, its lo kSub further);
// then V's raw rows, N rows of 64 floats.
constexpr int kFwdQ = 0, kFwdK = 3 * kSub, kFwdV = 6 * kSub;
constexpr int kFwdRaw = 10 * kSub;
constexpr size_t kFwdSmemBytes =
    1024 + kFwdRaw + kMaxN * kCols * sizeof(float);
static_assert(2 * (kFwdSmemBytes + 1024) <= 233472, "two CTAs an SM");

// The scalars of a launch.
struct FwdArgs {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int len;
  int heads;
  int d;
  float scale2;
  bool vec;  // 16-byte copies and 8-byte stores (see copy_rows)
};

// Element (i, c) of V's raw rows: 64 floats a row, 16-byte chunk j of row
// i at chunk j ^ (i % 8), so the transposing reads of eight rows' chunk j
// hit eight bank groups.
__device__ __forceinline__ float* raw_at(float* raw, int i, int c) {
  return raw + i * kCols + (((c >> 2) ^ (i & 7)) << 2) + (c & 3);
}

// Row r of the three-part tile at tile (32 columns, landed as f32 in part
// 0), split in place on the row's grid: 2^E the power of two at or below
// the row's largest |x|, part 0 = x rounded to a multiple of 2^(E -
// kGridBits) (rintf of x times a power of two, exact), part 1 = the rest
// x - part 0 rounded to tf32 and part 2 = what part 1 leaves, rounded the
// same way. A row below 2^(kGridBits - 126) keeps no part 0.
__device__ __forceinline__ void split_row(uint8_t* tile, int r) {
  float top = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 x =
        *reinterpret_cast<const float4*>(tile + swizzled(r, 4 * j));
    top = fmaxf(top, fmaxf(fmaxf(fabsf(x.x), fabsf(x.y)),
                           fmaxf(fabsf(x.z), fabsf(x.w))));
  }
  const int e = static_cast<int>(__float_as_uint(top) >> 23);  // biased E
  const bool grid = e > kGridBits;
  const float unit =
      grid ? __uint_as_float(static_cast<uint32_t>(e - kGridBits) << 23)
           : 0.f;
  const float inv = grid ? __uint_as_float(
                               static_cast<uint32_t>(254 + kGridBits - e)
                               << 23)
                         : 0.f;
  auto parts = [&](float v, float& p0, float& p1, float& p2) {
    p0 = rintf(v * inv) * unit;
    const float rest = v - p0;
    p1 = rna_tf32(rest);
    p2 = rna_tf32(rest - p1);
  };
  // A second read of the row, not its 32 values held: registers are
  // scarce beside the score accumulators.
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint8_t* p = tile + swizzled(r, 4 * j);
    const float4 x = *reinterpret_cast<const float4*>(p);
    float4 p0, p1, p2;
    parts(x.x, p0.x, p1.x, p2.x);
    parts(x.y, p0.y, p1.y, p2.y);
    parts(x.z, p0.z, p1.z, p2.z);
    parts(x.w, p0.w, p1.w, p2.w);
    *reinterpret_cast<float4*>(p) = p0;
    *reinterpret_cast<float4*>(p + kSub) = p1;
    *reinterpret_cast<float4*>(p + 2 * kSub) = p2;
  }
}

// One score step's products (see the header) over the 32 columns of the
// three-part tiles at q (64 rows) and k (kN rows): big = q0 k0 into a
// fresh accumulator, and the five terms of the rest added to lo (into a
// fresh one where `fresh`).
template <int kN>
__device__ __forceinline__ void score_step(float (&big)[kN / 2],
                                           float (&lo)[kN / 2],
                                           const uint8_t* q,
                                           const uint8_t* k, bool fresh) {
  uint64_t dq[3], dk[3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    dq[p] = sm90::desc_k_major(q + p * kSub);
    dk[p] = sm90::desc_k_major(k + p * kSub);
  }
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint64_t s = ks * sm90::kKMajorStep;
    mma<kN>(lo, dq[0] + s, dk[2] + s, fresh && ks == 0 ? 0 : 1);
    mma<kN>(big, dq[0] + s, dk[0] + s, ks == 0 ? 0 : 1);
    mma<kN>(lo, dq[2] + s, dk[0] + s, 1);
    mma<kN>(lo, dq[1] + s, dk[1] + s, 1);
    mma<kN>(lo, dq[0] + s, dk[1] + s, 1);
    mma<kN>(lo, dq[1] + s, dk[0] + s, 1);
  }
}

// Key i's column in V^T's tile i / 32: in each group of 8 keys, key 2 c
// goes to column c and key 2 c + 1 to column c + 4, where the A fragment
// (mma_rs) takes the accumulator's columns 2 t4 and 2 t4 + 1.
__device__ __forceinline__ int key_column(int i) {
  return (i & 24) | ((i & 1) << 2) | ((i & 7) >> 1);
}

// V's kN raw rows (keys, `raw_at`) transposed and split into V^T's pair of
// split tiles at dst: raw column c is tile row c, key i column
// key_column(i % 32) of tile i / 32. The 32 lanes of a warp take 32 keys
// of one 16-byte chunk; each of their four stores covers one tile row,
// free of bank conflicts where the keys are those of one tile. Not
// unrolled: it runs while the score accumulators are in flight, and
// unrolled, its loads are hoisted together and the kernel spills at N >=
// 56 (ptxas; chip_smoke.py's `[build]` lines give each instance's).
template <int kN>
__device__ __forceinline__ void split_v(uint8_t* dst, const float* raw) {
#pragma unroll 1
  for (int it = 0; it < kN * 16 / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int i = idx % kN, j = idx / kN;  // key, chunk (columns 4 j + e)
    const float4 x = *reinterpret_cast<const float4*>(
        raw + i * kCols + ((j ^ (i & 7)) << 2));
    const float v[4] = {x.x, x.y, x.z, x.w};
    uint8_t* hi = dst + (i / 32) * 2 * kSub;
    const int col = key_column(i % 32);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int off = swizzled(4 * j + e, col);
      float h, l;
      split(v[e], h, l);
      *reinterpret_cast<float*>(hi + off) = h;
      *reinterpret_cast<float*>(hi + kSub + off) = l;
    }
  }
}

// Grid (query tiles, H * column chunks, B).
template <class P, int kN>
__global__ void __launch_bounds__(kThreads, 2)
attn_f32x3_fwd_kernel(const FwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align_tiles(smem_raw);
  uint8_t* const tq = smem + kFwdQ;
  uint8_t* const tk = smem + kFwdK;
  uint8_t* const tv = smem + kFwdV;
  float* const raw = reinterpret_cast<float*>(smem + kFwdRaw);
  const int lane = threadIdx.x % 32, t4 = lane % 4;
  const int chunks = (a.d + kCols - 1) / kCols;
  const int col0 = (blockIdx.y % chunks) * kCols;
  const int q0 = blockIdx.x * kRows;
  const int stride = a.heads * a.d;
  const size_t base = static_cast<size_t>(blockIdx.z) * a.len * stride +
                      static_cast<size_t>(blockIdx.y / chunks) * a.d;
  const float* q = a.q + base;
  const float* k = a.k + base;
  const float* v = a.v + base;
  const int nd = (a.d + kChunkCols - 1) / kChunkCols;  // steps a chunk
  const int steps = (a.len + kN - 1) / kN * nd;
  auto part0 = [](uint8_t* t) {
    return [=](int r, int c) {
      return reinterpret_cast<float*>(t + swizzled(r, c));
    };
  };
  // Issues the copies of score step n (key chunk n / nd, columns 32 (n %
  // nd) of D): Q's rows and K's.
  auto land_scores = [&](int n) {
    if (n >= steps) return;
    const int c0 = (n % nd) * kChunkCols;
    copy_rows<kRows, kChunkCols>(part0(tq), q, q0, a.len, stride, c0, a.d,
                                 a.vec);
    copy_rows<kN, kChunkCols>(part0(tk), k, n / nd * kN, a.len, stride, c0,
                              a.d, a.vec);
  };
  // Issues the copies of V's rows of the key chunk from key k0.
  auto land_v = [&](int k0) {
    if (k0 >= a.len) return;
    copy_rows<kN, kCols>([=](int i, int c) { return raw_at(raw, i, c); }, v,
                         k0, a.len, stride, col0, a.d, a.vec);
  };
  land_scores(0);
  land_v(0);
  cp_async_commit();

  float o[32], m[2] = {-INFINITY, -INFINITY}, se[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  for (int k0 = 0, n = 0; k0 < a.len; k0 += kN) {
    // S = Q K^T as hi + lo, a score step a 32-column chunk of D.
    float hi[kN / 2], lo[kN / 2];
    for (int u = 0; u < nd; ++u, ++n) {
      const bool last = u == nd - 1;
      cp_async_wait_all();
      __syncthreads();
      if (threadIdx.x < kRows) {
        split_row(tq, threadIdx.x);
      } else if (threadIdx.x < kRows + kN) {
        split_row(tk, threadIdx.x - kRows);
      }
      sm90::fence_proxy_async();
      __syncthreads();
      float big[kN / 2];
      sm90::wgmma_fence();
      score_step<kN>(big, lo, tq, tk, u == 0);
      sm90::wgmma_commit();
      // V^T of this key chunk, split while the score products run (the
      // last chunk's e V products are done, and so are its readers').
      if (last) {
        split_v<kN>(tv, raw);
        sm90::fence_proxy_async();
      }
      sm90::wgmma_wait<0>();
      sm90::fence(big);
      sm90::fence(lo);
      if (u == 0) {
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) hi[i] = big[i];
      } else {
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) {  // two-sum: hi + err = hi + big
          const float sum = hi[i] + big[i];
          const float b = sum - hi[i];
          lo[i] += (hi[i] - (sum - b)) + (big[i] - b);
          hi[i] = sum;
        }
      }
      // Every thread is done with the score tiles and V's raw rows, and
      // V^T is written: the next rows may land.
      __syncthreads();
      land_scores(n + 1);
      if (last) land_v(k0 + kN);
      cp_async_commit();
    }
    // e from the policy, in hi; the row sums (and max).
    float alpha[2] = {1.f, 1.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (P::kShift) {
        float mt = -INFINITY;
#pragma unroll
        for (int n8 = 0; n8 < kN / 8; ++n8) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (k0 + 8 * n8 + 2 * t4 + j < a.len) {
              const int i = 4 * n8 + 2 * hh + j;
              mt = fmaxf(mt, scaled(hi[i], lo[i], a.scale2));
            }
          }
        }
        const float m_new = fmaxf(m[hh], sm90::quad_max(mt));
        alpha[hh] = exp2f(m[hh] - m_new);
        m[hh] = m_new;
        se[hh] *= alpha[hh];
      }
      float part = 0.f;
#pragma unroll
      for (int n8 = 0; n8 < kN / 8; ++n8) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = 4 * n8 + 2 * hh + j;
          const float e = k0 + 8 * n8 + 2 * t4 + j < a.len
                              ? P::e(hi[i], lo[i], a.scale2, m[hh])
                              : 0.f;
          hi[i] = e;
          part += e;
        }
      }
      se[hh] += sm90::quad_sum(part);
    }
    // o = o alpha + e V: e split into A registers, k8 step n8's fragment
    // (g, key 2 t4), (g + 8, key 2 t4), (g, key 2 t4 + 1), (g + 8, key
    // 2 t4 + 1) of the chunk's keys 8 n8 .. 8 n8 + 7.
    uint32_t ah[kN / 2], al[kN / 2];
#pragma unroll
    for (int n8 = 0; n8 < kN / 8; ++n8) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float h, l;  // register r from accumulator column 0, 2, 1, 3
        split(hi[4 * n8 + ((r >> 1) | ((r & 1) << 1))], h, l);
        ah[4 * n8 + r] = __float_as_uint(h);
        al[4 * n8 + r] = __float_as_uint(l);
      }
    }
    float t[32];
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kN / 8; ++ks) {
      const uint8_t* b = tv + (ks / 4) * 2 * kSub;
      const uint64_t step = (ks % 4) * sm90::kKMajorStep;
      const uint64_t bh = sm90::desc_k_major(b) + step;
      const uint64_t bl = sm90::desc_k_major(b + kSub) + step;
      const uint32_t eh[4] = {ah[4 * ks], ah[4 * ks + 1], ah[4 * ks + 2],
                              ah[4 * ks + 3]};
      const uint32_t el[4] = {al[4 * ks], al[4 * ks + 1], al[4 * ks + 2],
                              al[4 * ks + 3]};
      mma_rs(t, el, bh, ks == 0 ? 0 : 1);
      mma_rs(t, eh, bl, 1);
      mma_rs(t, eh, bh, 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence(t);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      o[i] = (P::kShift ? o[i] * alpha[(i / 2) % 2] : o[i]) + t[i];
    }
  }
  const float f[2] = {1.f / se[0], 1.f / se[1]};
  store_out(a.o + base, stride, q0, a.len, col0, a.d, o, f, a.vec);
}

// ---- host -------------------------------------------------------------------

template <class P, int kN>
int forward_n(const FwdArgs& a, int batch, cudaStream_t stream) {
  const dim3 grid((a.len + kRows - 1) / kRows,
                  a.heads * ((a.d + kCols - 1) / kCols), batch);
  return static_cast<int>(launch_one(attn_f32x3_fwd_kernel<P, kN>, grid,
                                     kFwdSmemBytes, a, stream));
}

// The forward on `stream`: o from q, k, v, (B, L, H*D) f32. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape the kernel
// does not take.
template <class P>
int attn_forward(const float* q, const float* k, const float* v, float* o,
                 int batch, int len, int heads, int d, float scale2,
                 cudaStream_t stream) {
  if (!attn_takes(batch, len, heads, d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = d % 4 == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v) && aligned16(o);
  const FwdArgs a{q, k, v, o, len, heads, d, scale2, vec};
  switch (chunk_width(len)) {
    case 8: return forward_n<P, 8>(a, batch, stream);
    case 16: return forward_n<P, 16>(a, batch, stream);
    case 24: return forward_n<P, 24>(a, batch, stream);
    case 32: return forward_n<P, 32>(a, batch, stream);
    case 40: return forward_n<P, 40>(a, batch, stream);
    case 48: return forward_n<P, 48>(a, batch, stream);
    case 56: return forward_n<P, 56>(a, batch, stream);
    case 64: return forward_n<P, 64>(a, batch, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace f32x3
