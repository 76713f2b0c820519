// The store of one warp's 16 x 64 f32 head output (mma.sync's m16n8
// accumulator layout) as bf16 rows, for the unpacked attention backward
// (K8, attention_unpacked_bwd.cu), the one kernel left on mma.sync and
// cp.async. The max-shift forward, K6's attention stage, K7 and K9 run on
// the Hopper core of sm90_attention.cuh.

#pragma once

#include "mma.cuh"

namespace tiles {

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
