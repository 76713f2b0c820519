// The max-shift softmax attention of one warp's 16 query rows against a
// head's keys and values held in shared memory: the arithmetic that
// small_vision_tpu/ops/attention.py::_attn_kernel and
// small_vision_tpu/ops/fused_block.py::_mha_kernel share,
//   S = (Q K^T) * scale, keys past L masked to -inf          (f32)
//   m = rowmax(S);  e = exp(S - m);  p = bf16(e / rowsum(e))
//   O = p V                                                  (f32 sums)
// Used by the unpacked attention forward and by the fused MHA forward.
//
// Two passes over the keys in blocks of 16. The first keeps, per lane, a
// running max and a sum of exp rescaled whenever the max grows (each lane
// sees 4 of a block's 16 keys for each of its two rows); the four lanes of
// a row then merge theirs. The second recomputes S the same way (so the
// same bits), forms p with the final max and sum, rounds it, and feeds
// it to the PV product as an A fragment straight from registers. V is read
// row-major through ldmatrix.trans, so nothing is staged transposed.

#pragma once

#include <math_constants.h>

#include "mma.cuh"

namespace tiles {

// q_s: the tile that holds the query rows, k_s, v_s: the head's keys and
// values; all row-major [.][kRowStride] bf16 in shared memory, rows past
// seq_len finite (zero or any finite value). r0: first of the warp's 16
// rows within q_s. lk_pad: the keys, padded to a multiple of 16. Leaves the
// 16 x 64 f32 head output in `acc`.
__device__ __forceinline__ void attn_maxshift_rows(
    float (&acc)[8][4], const __nv_bfloat16* q_s, int r0,
    const __nv_bfloat16* k_s, const __nv_bfloat16* v_s, int lk_pad,
    int seq_len, float scale, int lane) {
  const int t4 = lane & 3;
  uint32_t qa[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    load_a(qa[ks], q_s, kRowStride, r0, ks * 16, lane);
  }

  // Pass 1: this lane's running max and rescaled sum, rows g and g + 8.
  float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F, l_lo = 0.f, l_hi = 0.f;
  for (int kb = 0; kb < lk_pad; kb += 16) {
    float s[2][4];
    dot_rows(s, qa, k_s, kb, lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kb + nt * 8 + t4 * 2 + (i & 1);
        s[nt][i] = key < seq_len ? s[nt][i] * scale : -CUDART_INF_F;
      }
    }
    const float n_lo = fmaxf(
        m_lo, fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1])));
    const float n_hi = fmaxf(
        m_hi, fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3])));
    if (n_lo > -CUDART_INF_F) {  // else every key so far is masked
      l_lo = l_lo * expf(m_lo - n_lo) + expf(s[0][0] - n_lo) +
             expf(s[0][1] - n_lo) + expf(s[1][0] - n_lo) +
             expf(s[1][1] - n_lo);
      m_lo = n_lo;
    }
    if (n_hi > -CUDART_INF_F) {
      l_hi = l_hi * expf(m_hi - n_hi) + expf(s[0][2] - n_hi) +
             expf(s[0][3] - n_hi) + expf(s[1][2] - n_hi) +
             expf(s[1][3] - n_hi);
      m_hi = n_hi;
    }
  }
  // Merge the four lanes of a row (a lane that saw no key has l = 0 and
  // exp(-inf) = 0).
  const float row_m_lo = quad_max(m_lo);
  const float row_m_hi = quad_max(m_hi);
  const float inv_lo = 1.f / quad_sum(l_lo * expf(m_lo - row_m_lo));
  const float inv_hi = 1.f / quad_sum(l_hi * expf(m_hi - row_m_hi));

  // Pass 2: p for each key block, rounded, times V.
  zero_acc(acc);
  for (int kb = 0; kb < lk_pad; kb += 16) {
    float s[2][4];
    dot_rows(s, qa, k_s, kb, lane);
    uint32_t pa[4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kb + nt * 8 + t4 * 2 + (i & 1);
        const float m = i < 2 ? row_m_lo : row_m_hi;
        const float inv = i < 2 ? inv_lo : inv_hi;
        p[i] = key < seq_len ? expf(s[nt][i] * scale - m) * inv : 0.f;
      }
      pa[nt * 2 + 0] = pack_bf16(p[0], p[1]);
      pa[nt * 2 + 1] = pack_bf16(p[2], p[3]);
    }
    acc_rows(acc, pa, v_s, kb, lane);
  }
}

// Stores rows lo and lo + 8 of a 16 x 64 f32 accumulator as bf16, times
// f_lo / f_hi, to `out` (row-major, `ld` elements a row, already offset to
// the first column), dropping rows at or past `rows`.
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, size_t ld,
                                           int row_lo, int rows,
                                           const float (&acc)[8][4],
                                           float f_lo, float f_hi, int lane) {
  const int t4 = lane & 3;
  __nv_bfloat16* o_lo = out + static_cast<size_t>(row_lo) * ld;
  __nv_bfloat16* o_hi = o_lo + 8 * ld;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int col = dt * 8 + t4 * 2;
    if (row_lo < rows) {
      *reinterpret_cast<uint32_t*>(o_lo + col) =
          pack_bf16(acc[dt][0] * f_lo, acc[dt][1] * f_lo);
    }
    if (row_lo + 8 < rows) {
      *reinterpret_cast<uint32_t*>(o_hi + col) =
          pack_bf16(acc[dt][2] * f_hi, acc[dt][3] * f_hi);
    }
  }
}

}  // namespace tiles
