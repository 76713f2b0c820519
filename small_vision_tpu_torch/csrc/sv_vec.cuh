// Vectors of bf16 or f32 widened to f32 and back, for the LayerNorm
// kernels' instances of any dtype and width (`ln_modulate_fwd_any`,
// `ln_modulate_bwd_any`): a load or store of VEC elements (1, 2, 4 or 8,
// at most 16 bytes) at an address aligned to them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sv_vec {

// Widest row the any-width instances take, and the values of a row a lane
// holds at most (past 32 x kLaneValues columns, several warps share a row).
constexpr int kAnyMaxWidth = 8192;
constexpr int kLaneValues = 32;

// Warps a row of d columns: 1 up to 1,024, then 2, 4 or 8.
__host__ __device__ constexpr int warps_a_row(int d) {
  return d <= 1024 ? 1 : d <= 2048 ? 2 : d <= 4096 ? 4 : 8;
}

template <int kBytes> struct Raw;
template <> struct Raw<16> { using T = uint4; };
template <> struct Raw<8> { using T = uint2; };
template <> struct Raw<4> { using T = uint32_t; };
template <> struct Raw<2> { using T = uint16_t; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename E> __device__ __forceinline__ E from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC elements at p widened to f32, and back.
template <typename E, int VEC>
__device__ __forceinline__ void load_vec(const E* p, float* out) {
  using R = typename Raw<VEC * sizeof(E)>::T;
  const R raw = *reinterpret_cast<const R*>(p);
  const E* e = reinterpret_cast<const E*>(&raw);
#pragma unroll
  for (int j = 0; j < VEC; ++j) out[j] = to_f32(e[j]);
}

template <typename E, int VEC>
__device__ __forceinline__ void store_vec(E* p, const float* in) {
  using R = typename Raw<VEC * sizeof(E)>::T;
  R raw;
  E* e = reinterpret_cast<E*>(&raw);
#pragma unroll
  for (int j = 0; j < VEC; ++j) e[j] = from_f32<E>(in[j]);
  *reinterpret_cast<R*>(p) = raw;
}

}  // namespace sv_vec
