// Attention in plain f32 on the CUDA cores (SIMT FMA), the forward,
// under a compile-time softmax policy: K3's f32 instance
// (attention_packed_f32.cu) under `ClampExp2`, K6's attention stage
// (fused_mha_f32.cu) and K7 (attention_unpacked_f32.cu) under `MaxShift`.
// The f32 backwards (K4's and K8's instances) run on the TF32 tensor cores
// in sm90_f32x3_attention_bwd.cuh, under the same policies. On rows of
// heads (B, L, H*D) (or [B, L, H, D], the same memory), per batch row and
// head, with scale2 = D**-0.5 log2(e):
//   t = (q k^T) scale2
//   ClampExp2: e = exp2(clamp(t, -80, 80))       (no max: the clamp bounds e)
//   MaxShift:  e = exp2(t - m), m = the row max of t over the valid keys
//   e = 0 for keys past L; o = (e v) / rowsum(e)
//
// Bound on this card: operations. A score product and a value product are
// 4 B H L^2 D operations (13.3 GFLOP at the sampler's (64, 260), 768 wide:
// 0.20 ms at 67 TFLOP/s of f32 FMA) against 16 B H L D bytes.
//
// Design: plain f32 FMA, no tensor cores. A CTA of 256 threads (16 x 16)
// owns a tile of 64 query rows of one (b, h) and 64 output columns of the
// head; each thread holds a 4 x 4 tile of the scores or outputs, on rows
// ty + 16 i and columns tx + 16 j, so its shared-memory reads of both
// operands are free of bank conflicts. The score product walks the head's
// D columns in chunks of 32, staging both operands' chunks in shared
// memory, and so takes every head dim from 1 to 2,048 in registers of a
// fixed size; past 64 columns the outputs' columns are split across CTAs
// (gridDim.y), each recomputing the scores, as the wide bf16 path does.
// The forward adds e v and e over the key tiles in a fixed order; under
// MaxShift it keeps a running row max and rescales the sums when it grows
// (online softmax), so the scores are computed once. Rows past L read as
// zeros, and nothing past L or D is stored. q, k and v rows are
// `in_stride` floats apart and the output rows `out_stride` (K6 reads its
// q, k, v side by side in one buffer).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace simt_f32 {

constexpr int kTile = 64;    // query or key rows of a tile
constexpr int kChunk = 32;   // depth of a staged chunk of a score product
constexpr int kCols = 64;    // output columns of a CTA
constexpr int kThreads = 256;
constexpr int kMaxLen = 4096;
constexpr int kMaxHeadDim = 2048;
constexpr float kClamp = 80.f;

constexpr int kChunkStride = kChunk + 1;  // shared rows, padded
constexpr int kTileStride = kTile + 1;
constexpr int kChunkFloats = kTile * kChunkStride;
constexpr int kTileFloats = kTile * kTileStride;

// The clamped exp2 softmax of the packed TPU kernels (K3, K4): no max.
struct ClampExp2 {
  static constexpr bool kShift = false;
  static __device__ __forceinline__ float e(float s, float scale2, float) {
    return exp2f(fminf(fmaxf(s * scale2, -kClamp), kClamp));
  }
};

// The max-shift softmax (K6, K7, K8): exp2 of the log2(e)-scaled scores
// less their row max m.
struct MaxShift {
  static constexpr bool kShift = true;
  static __device__ __forceinline__ float e(float s, float scale2,
                                            float m) {
    return exp2f(s * scale2 - m);
  }
};

// rows [row0, row0 + 64) x columns [col0, col0 + kChunk) of a head whose
// rows are `stride` floats apart (zeros past L and past D) into dst
// [64][kChunkStride].
__device__ __forceinline__ void load_chunk(float* dst, const float* src,
                                           int row0, int len, int stride,
                                           int col0, int d) {
#pragma unroll
  for (int it = 0; it < kTile * kChunk / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx / kChunk, c = idx % kChunk;
    const int row = row0 + r, col = col0 + c;
    dst[r * kChunkStride + c] =
        row < len && col < d ? src[static_cast<size_t>(row) * stride + col]
                             : 0.f;
  }
}

// rows [row0, row0 + 64) x columns [col0, col0 + 64) (zeros past L and D)
// into dst [64][kTileStride], each row times `row_scale[r]` where given.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int len, int stride,
                                          int col0, int d,
                                          const float* row_scale) {
#pragma unroll
  for (int it = 0; it < kTile * kCols / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx / kCols, c = idx % kCols;
    const int row = row0 + r, col = col0 + c;
    float v = row < len && col < d
                  ? src[static_cast<size_t>(row) * stride + col]
                  : 0.f;
    if (row_scale != nullptr) v *= row_scale[r];
    dst[r * kTileStride + c] = v;
  }
}

// acc0[i][j] = sum over the head's d columns of a0[arow0 + ty + 16 i] .
// b0[brow0 + tx + 16 j] (and acc1 of a1, b1 where kTwo), summed column by
// column in order. stage: 2 (or 4) chunks of kChunkFloats. Starts and ends
// with a block barrier, so the caller may reuse `stage` on either side.
template <bool kTwo>
__device__ __forceinline__ void score_tiles(
    const float* a0, const float* b0, const float* a1, const float* b1,
    int arow0, int brow0, int len, int stride, int d, float* stage,
    float (&acc0)[4][4], float (&acc1)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc0[i][j] = acc1[i][j] = 0.f;
  }
  float* sa0 = stage;
  float* sb0 = stage + kChunkFloats;
  float* sa1 = stage + 2 * kChunkFloats;
  float* sb1 = stage + 3 * kChunkFloats;
  for (int c0 = 0; c0 < d; c0 += kChunk) {
    __syncthreads();
    load_chunk(sa0, a0, arow0, len, stride, c0, d);
    load_chunk(sb0, b0, brow0, len, stride, c0, d);
    if (kTwo) {
      load_chunk(sa1, a1, arow0, len, stride, c0, d);
      load_chunk(sb1, b1, brow0, len, stride, c0, d);
    }
    __syncthreads();
    const int cols = min(kChunk, d - c0);
    for (int c = 0; c < cols; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sa0[(ty + 16 * i) * kChunkStride + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sb0[(tx + 16 * j) * kChunkStride + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc0[i][j] = fmaf(a[i], b[j], acc0[i][j]);
      }
      if (kTwo) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = sa1[(ty + 16 * i) * kChunkStride + c];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[j] = sb1[(tx + 16 * j) * kChunkStride + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc1[i][j] = fmaf(a[i], b[j], acc1[i][j]);
          }
        }
      }
    }
  }
  __syncthreads();
}

// out[i][j] += sum over k < 64, in order, of p[ty + 16 i][k] *
// t[k][tx + 16 j] (both [64][kTileStride] in shared memory).
__device__ __forceinline__ void tile_product(const float* p, const float* t,
                                             float (&out)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = p[(ty + 16 * i) * kTileStride + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = t[k * kTileStride + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = fmaf(a[i], b[j], out[i][j]);
    }
  }
}

// The sum (and the max) of v over the 16 threads of a row of the thread
// grid (lanes that share ty: half a warp).
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// MaxShift's running statistics of a thread's 4 rows over one key tile:
// the new row max of t = s scale2 over the tile's valid keys; the sums
// kept so far (`sums`, each of `n` per row) and `out` (may be null) are
// rescaled to it. A tile holds at least one valid key, so the max is
// finite after the first one (whose rescale factor is exp2(-inf) = 0).
template <int kN>
__device__ __forceinline__ void shift_rows(const float (&s)[4][4],
                                           float scale2, int k0, int len,
                                           float (&m)[4],
                                           float (&sums)[kN][4],
                                           float (*out)[4]) {
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k0 + tx + 16 * j < len) mt = fmaxf(mt, s[i][j] * scale2);
    }
    const float m_new = fmaxf(m[i], row_max16(mt));
    const float alpha = exp2f(m[i] - m_new);
    m[i] = m_new;
#pragma unroll
    for (int n = 0; n < kN; ++n) sums[n][i] *= alpha;
    if (out != nullptr) {
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] *= alpha;
    }
  }
}

// Grid (query tiles, H * column chunks, B). o = (e v) / rowsum(e).
template <class P>
__global__ void __launch_bounds__(kThreads)
attn_f32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    int len, int heads, int d, int in_stride, int out_stride,
                    float scale2) {
  __shared__ __align__(16) float smem[4 * kChunkFloats];
  float* e_tile = smem;                  // [64][65], over the chunks
  float* v_tile = smem + kTileFloats;    // [64][65]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int chunks = (d + kCols - 1) / kCols;
  const int h = blockIdx.y / chunks;
  const int col0 = (blockIdx.y % chunks) * kCols;
  const int q0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(blockIdx.z) * len * in_stride +
                      static_cast<size_t>(h) * d;
  const size_t out_base =
      static_cast<size_t>(blockIdx.z) * len * out_stride +
      static_cast<size_t>(h) * d;

  float acc[4][4], unused[4][4], out[4][4], sum[1][4], m[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sum[0][i] = 0.f;
    m[i] = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < len; k0 += kTile) {
    score_tiles<false>(q + base, k + base, nullptr, nullptr, q0, k0, len,
                       in_stride, d, smem, acc, unused);
    if (P::kShift) shift_rows<1>(acc, scale2, k0, len, m, sum, out);
    // The stage is free (score_tiles ends at a barrier): e and V there.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool key = k0 + tx + 16 * j < len;
        const float e = key ? P::e(acc[i][j], scale2, m[i]) : 0.f;
        e_tile[(ty + 16 * i) * kTileStride + tx + 16 * j] = e;
        part += e;
      }
      sum[0][i] += row_sum16(part);
    }
    load_tile(v_tile, v + base, k0, len, in_stride, col0, d, nullptr);
    __syncthreads();
    tile_product(e_tile, v_tile, out);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= len) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < d) {
        o[out_base + static_cast<size_t>(row) * out_stride + col] =
            out[i][j] / sum[0][i];
      }
    }
  }
}

inline bool attn_takes(int batch, int len, int heads, int d) {
  return batch >= 1 && batch <= 65535 && len >= 1 && len <= kMaxLen &&
         heads >= 1 && d >= 1 && d <= kMaxHeadDim &&
         static_cast<long long>(heads) * ((d + kCols - 1) / kCols) <= 65535;
}

// The forward on `stream`. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernel does not take.
template <class P>
int attn_f32_forward(const float* q, const float* k, const float* v,
                     float* o, int batch, int len, int heads, int d,
                     int in_stride, int out_stride, float scale2,
                     cudaStream_t stream) {
  if (!attn_takes(batch, len, heads, d) || in_stride < heads * d ||
      out_stride < heads * d) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((len + kTile - 1) / kTile,
                  heads * ((d + kCols - 1) / kCols), batch);
  attn_f32_fwd_kernel<P><<<grid, kThreads, 0, stream>>>(
      q, k, v, o, len, heads, d, in_stride, out_stride, scale2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt_f32
