// Attention in plain f32 on the CUDA cores (SIMT FMA), the forward under
// a compile-time softmax policy (sm90_f32x3.cuh's): K6's f32 attention
// stage (fused_mha_f32.cu) under `MaxShift`, the one kernel that still
// launches it. K3's and K7's f32 forwards (sm90_f32x3_attention.cuh) and
// K4's and K8's f32 backwards (sm90_f32x3_attention_bwd.cuh) run on the
// TF32 tensor cores, under the same policies. On rows of heads (B, L,
// H*D), per batch row and head, with scale2 = D**-0.5 log2(e):
//   t = (q k^T) scale2
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

#include "sm90_f32x3.cuh"

namespace simt_f32 {

constexpr int kTile = 64;    // query or key rows of a tile
constexpr int kChunk = 32;   // depth of a staged chunk of a score product
constexpr int kCols = 64;    // output columns of a CTA
constexpr int kThreads = 256;

constexpr int kChunkStride = kChunk + 1;  // shared rows, padded
constexpr int kTileStride = kTile + 1;
constexpr int kChunkFloats = kTile * kChunkStride;
constexpr int kTileFloats = kTile * kTileStride;

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
// into dst [64][kTileStride].
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int len, int stride,
                                          int col0, int d) {
#pragma unroll
  for (int it = 0; it < kTile * kCols / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx / kCols, c = idx % kCols;
    const int row = row0 + r, col = col0 + c;
    dst[r * kTileStride + c] =
        row < len && col < d ? src[static_cast<size_t>(row) * stride + col]
                             : 0.f;
  }
}

// acc[i][j] = sum over the head's d columns of a[arow0 + ty + 16 i] .
// b[brow0 + tx + 16 j], summed column by column in order. stage: 2 chunks
// of kChunkFloats. Starts and ends with a block barrier, so the caller may
// reuse `stage` on either side.
__device__ __forceinline__ void score_tiles(const float* a, const float* b,
                                            int arow0, int brow0, int len,
                                            int stride, int d, float* stage,
                                            float (&acc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  float* sa = stage;
  float* sb = stage + kChunkFloats;
  for (int c0 = 0; c0 < d; c0 += kChunk) {
    __syncthreads();
    load_chunk(sa, a, arow0, len, stride, c0, d);
    load_chunk(sb, b, brow0, len, stride, c0, d);
    __syncthreads();
    const int cols = min(kChunk, d - c0);
    for (int c = 0; c < cols; ++c) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sa[(ty + 16 * i) * kChunkStride + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sb[(tx + 16 * j) * kChunkStride + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
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
// the new row max of t = s scale2 over the tile's valid keys; the row sums
// kept so far and `out` are rescaled to it. A tile holds at least one
// valid key, so the max is finite after the first one (whose rescale
// factor is exp2(-inf) = 0).
__device__ __forceinline__ void shift_rows(const float (&s)[4][4],
                                           float scale2, int k0, int len,
                                           float (&m)[4], float (&sum)[4],
                                           float (&out)[4][4]) {
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
    sum[i] *= alpha;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] *= alpha;
  }
}

// Grid (query tiles, H * column chunks, B). o = (e v) / rowsum(e).
template <class P>
__global__ void __launch_bounds__(kThreads)
attn_f32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    int len, int heads, int d, int in_stride, int out_stride,
                    float scale2) {
  // score_tiles' two chunks, then e and V.
  static_assert(2 * kChunkFloats <= 2 * kTileFloats, "the stage");
  __shared__ __align__(16) float smem[2 * kTileFloats];
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

  float acc[4][4], out[4][4], sum[4], m[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sum[i] = 0.f;
    m[i] = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < len; k0 += kTile) {
    score_tiles(q + base, k + base, q0, k0, len, in_stride, d, smem, acc);
    if (P::kShift) shift_rows(acc, scale2, k0, len, m, sum, out);
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
      sum[i] += row_sum16(part);
    }
    load_tile(v_tile, v + base, k0, len, in_stride, col0, d);
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
            out[i][j] / sum[i];
      }
    }
  }
}

// The forward on `stream`. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernel does not take.
template <class P>
int attn_f32_forward(const float* q, const float* k, const float* v,
                     float* o, int batch, int len, int heads, int d,
                     int in_stride, int out_stride, float scale2,
                     cudaStream_t stream) {
  if (!f32x3::attn_takes(batch, len, heads, d) || in_stride < heads * d ||
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
