// Hopper (sm_90a) pieces beside sm90.cuh for the fused MHA forward (K6):
// 2-D TMA copies both ways (stores from swizzled tiles), the m64n128k16
// product whose MN-major B spans two 64-column swizzle atoms, ex2 without
// the denormal handling, and the host's 2-D and strided 3-D tensor maps.
//
// An MN-major B of 128 columns is two 64 x 64 tiles (two TMA boxes) one
// after the other: in its descriptor the leading byte offset is the step
// from one 64-column atom to the next (8 KB), the stride byte offset the
// step from one group of 8 contraction rows to the next (1024 bytes).

#pragma once

#include "sm90.cuh"

namespace sm90 {

#define SM90G_D8(i)                                                       \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// One box of a 2-D tensor map into shared memory; completion is counted on
// `bar` in bytes. Coordinates are innermost first.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// One box of shared memory to a 2-D tensor map: a bulk group of
// this thread's, committed by bulk_commit. Elements out of bounds are not
// written. The shared bytes must have been made visible to the async
// proxy (fence_proxy_async, then a barrier) by the threads that wrote them.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(map),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most kPending of this thread's bulk groups still read
// shared memory (their sources may then be written again).
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending)
               : "memory");
}

// Waits until at most kPending of this thread's bulk groups are incomplete.
template <int kPending>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Stores the pair (lo, hi) as bf16 at row r, columns c, c + 1 (c even) of
// a 64 x 64 tile laid out as TMA's 128-byte swizzle.
__device__ __forceinline__ void st_swizzled(uint8_t* tile, int r, int c,
                                            float lo, float hi) {
  *reinterpret_cast<uint32_t*>(tile + r * 128 +
                               (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2) =
      pack_bf16(lo, hi);
}

// Two MN-major 64 x 64 tiles side by side as one B of N = 128.
__device__ __forceinline__ uint64_t desc_mn_major_n128(const void* tile) {
  return make_desc(smem_u32(tile), kTileBytes, 1024);
}

// D (64 x 128, f32) = [D +] A B, A K-major from shared memory, B MN-major
// (transpose-B). The accumulator's layout is wgmma_ss's, 16 n-tiles of 8.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : SM90G_D8(0), SM90G_D8(8), SM90G_D8(16), SM90G_D8(24),
        SM90G_D8(32), SM90G_D8(40), SM90G_D8(48), SM90G_D8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef SM90G_D8

// 2^x by the SFU alone (denormal results flush to zero).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace sm90

namespace sm90_host {

// Tensor map over a row-major (rows, cols) bf16 matrix with `ld` elements
// a row, box of `box_rows` rows by 64 columns with the 128-byte swizzle.
// Rows and columns out of bounds arrive as zeros.
inline bool matrix_map(CUtensorMap* map, const void* base, int rows,
                       int cols, int ld, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tensor map over a (batch, seq_len, cols) bf16 tensor with `ld` elements
// a row (cols <= ld), viewed as (cols, seq_len, batch) innermost first,
// box (64, 64, 1) with the 128-byte swizzle: one box is 64 columns of 64
// rows of one batch element, and rows at or past seq_len arrive as zeros.
inline bool rows_map(CUtensorMap* map, const void* base, int batch,
                     int seq_len, int cols, int ld) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(ld) * 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(seq_len),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {row_bytes, row_bytes * seq_len};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90_host
