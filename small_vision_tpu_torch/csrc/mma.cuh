// Warp-level building blocks shared by the kernels that hold matrix
// products in their own body: the bf16 mma.sync tile (m16n8k16, f32
// accumulate), its fragment loads from shared memory, and cp.async copies
// from device memory into shared memory.
//
// Fragment conventions (PTX ISA, mma.m16n8k16): with g = lane / 4 and
// t4 = lane % 4, a thread holds
//   A (16 x 16, row-major):  a0 = A[g][2 t4 .. +1],     a1 = A[g + 8][same],
//                            a2 = A[g][2 t4 + 8 .. +9], a3 = A[g + 8][same]
//   B (16 x 8):              b0 = B[2 t4 .. +1][g],     b1 = B[2 t4 + 8 ..][g]
//   C (16 x 8, f32):         c0, c1 = C[g][2 t4 .. +1], c2, c3 = C[g + 8][..]
// so the C fragments of two neighbouring n-tiles are the A fragment of a
// following product. Shared-memory tiles are row-major with kRowStride =
// 64 + 8 bf16 a row (144 bytes): the 8 rows of one fragment load fall in
// distinct banks, and every row starts on a 16-byte boundary for ldmatrix.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tiles {

constexpr int kRowStride = 64 + 8;  // bf16 per shared row of a 64-wide tile

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of rows r0..r0+15, columns c0..c0+15 of a row-major shared
// tile with `stride` bf16 a row.
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int stride,
                                       int r0, int c0, int lane) {
  const __nv_bfloat16* p0 =
      tile + (r0 + (lane >> 2)) * stride + c0 + (lane & 3) * 2;
  const __nv_bfloat16* p1 = p0 + 8 * stride;
  a[0] = ld32(p0);
  a[1] = ld32(p1);
  a[2] = ld32(p0 + 8);
  a[3] = ld32(p1 + 8);
}

// B fragments of two neighbouring n-tiles from a row-major [k][n] shared
// tile (`stride` bf16 a row): rows k0..k0+15, columns n0..n0+15. Gives
// {b0, b1} of columns n0..n0+7 in r[0], r[1] and of n0+8..n0+15 in r[2],
// r[3]. ldmatrix reads 8 x 8 matrices whose rows are 16 contiguous bytes;
// .trans hands each thread the two k-neighbours of one column, which is the
// B fragment's layout. Lane l addresses row (l % 8) of matrix (l / 8).
__device__ __forceinline__ void load_b_pair_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* tile,
                                                  int stride, int k0, int n0,
                                                  int lane) {
  const int mi = lane >> 3;
  const __nv_bfloat16* p =
      tile + (k0 + (mi & 1) * 8 + (lane & 7)) * stride + n0 + (mi >> 1) * 8;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// acc (16 x 64, f32) += P (16 x 16, A fragment `pa`) times rows
// k0..k0+15 of a row-major [.][kRowStride] shared matrix of 64 columns.
__device__ __forceinline__ void acc_rows(float (&acc)[8][4],
                                         const uint32_t (&pa)[4],
                                         const __nv_bfloat16* m_s, int k0,
                                         int lane) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t b[4];
    load_b_pair_trans(b, m_s, kRowStride, k0, np * 16, lane);
    mma_bf16_16816(acc[np * 2], pa, b[0], b[1]);
    mma_bf16_16816(acc[np * 2 + 1], pa, b[2], b[3]);
  }
}

// s = A M^T for 16 rows of A (fragments `a` of the four 16-wide steps over
// 64 columns) against rows r0..r0+15 of a row-major [.][kRowStride] shared
// matrix M: two (m16, n8) accumulators.
__device__ __forceinline__ void dot_rows(float (&s)[2][4],
                                         const uint32_t (&a)[4][4],
                                         const __nv_bfloat16* m_s, int r0,
                                         int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
    const __nv_bfloat16* mr = m_s + (r0 + nt * 8 + g) * kRowStride + t4 * 2;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      mma_bf16_16816(s[nt], a[ks], ld32(mr + ks * 16), ld32(mr + ks * 16 + 8));
    }
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[8][4]) {
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return v;
}

// 16 bytes from device memory to shared memory without passing through
// registers; with `valid` false the 16 bytes are zero-filled and `src` is
// not read. Both addresses are 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Copies a rows x cols bf16 tile (cols a multiple of 8) from a row-major
// device matrix with `src_ld` elements a row to a shared tile with
// `dst_stride` elements a row, 16 bytes a copy; rows at or past
// `valid_rows` are zero-filled.
__device__ __forceinline__ void cp_async_tile(__nv_bfloat16* dst,
                                              int dst_stride,
                                              const __nv_bfloat16* src,
                                              size_t src_ld, int rows,
                                              int cols, int valid_rows,
                                              int tid, int threads) {
  const int per_row = cols >> 3;
  for (int idx = tid; idx < rows * per_row; idx += threads) {
    const int r = idx / per_row;
    const int c = (idx - r * per_row) * 8;
    const bool ok = r < valid_rows;
    cp_async16(dst + r * dst_stride + c,
               src + (ok ? static_cast<size_t>(r) * src_ld + c : 0), ok);
  }
}

}  // namespace tiles
