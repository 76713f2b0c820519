// LayerNorm + AdaLN modulate, forward, for Hopper (sm_90a).
//
// Replaces: small_vision_tpu/ops/layernorm.py::_ln_fwd_kernel (reached via
// _ln_fwd / fused_ln_modulate). Computes, per row of D features,
//   mean = mean(x); var = mean((x - mean)^2); rstd = rsqrt(var + eps)
//   y = ((x - mean) * rstd * gamma + beta) * (1 + scale[b]) + shift[b]
// with statistics in f32, gamma/beta in f32, shift/scale widened from bf16,
// and y stored in bf16. shift == scale == nullptr gives a plain LayerNorm.
// mean and rstd are written only when the caller passes buffers for them.
//
// Bound on this card: memory. One read of x and one write of y, about
// 4*B*L*D bytes, against ~9 f32 operations per element: far under the
// card's operations-per-byte balance.
//
// Design: a team of T lanes of one warp per row (T = 32 for rows of 256
// columns or more; 4, 8 or 16 for narrower ones, so that a warp takes
// 32 / T rows and no lane of a narrow row is left without a vector), so the
// row's reductions are shuffles within the team and no shared memory or
// block barrier is needed. Each lane holds NV vectors of 8 elements in
// registers, loaded and stored as 16-byte vectors (8 bf16) at addresses
// that neighbouring lanes make contiguous, so every load and store is a
// full coalesced transaction. Lane q of a team owns vectors q, q + T, ...;
// where T does not divide the row's D / 8 vectors, the last ones are left
// out (masked), never read past the row. x is read once; the centred
// values stay in registers for the variance pass, as the TPU kernel's
// two-pass mean((x - mean)^2) does. D is any multiple of 32 up to 2,048:
// every width of the ViT and UMD variant tables.
//
// Every other input runs `ln_modulate_fwd_any_kernel` (the entry point
// `ln_modulate_fwd_any`): x, y, shift and scale in f32 (the TPU kernel is
// generic in x's dtype: `dtype_mm="float32"` runs it in f32), and bf16 rows
// of any other width, from 1 to 8,192. Its element type E is a template
// parameter; gamma, beta and the statistics stay f32. A row's width need
// not be a multiple of the 16-byte vector, so the caller gives the vector
// VEC (1, 2, 4 or 8 elements, at most 16 bytes) that divides the width and
// the modulation's row stride and to which every pointer is aligned: rows
// then start on VEC-element boundaries, and no tensor is padded. Past
// 1,024 columns a row no longer fits one warp's registers (32 values a
// lane), so kW = 2, 4 or 8 warps share it, and its two sums cross the
// warps through shared memory (added in warp order, so two launches give
// the same bits). Both the f32 kernel and the narrow-vector ones stay
// bound by memory: f32 doubles the bytes and changes nothing else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sv_vec.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxWidth = 2048;

template <int T>
__device__ __forceinline__ float team_sum(float v) {
#pragma unroll
  for (int off = T / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

// Lanes a row and vectors a lane for a width d (a multiple of 32): T the
// largest power of two up to 32 that is at most d / 8, NV = ceil(d/8 / T).
__host__ __device__ constexpr int team_lanes(int d) {
  int t = 32;
  while (t > d / 8) t >>= 1;
  return t;
}

template <int T, int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ln_modulate_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       const __nv_bfloat16* __restrict__ shift,
                       const __nv_bfloat16* __restrict__ scale,
                       int mod_stride,
                       __nv_bfloat16* __restrict__ y,
                       float* __restrict__ mean_out,
                       float* __restrict__ rstd_out,
                       int rows, int seq_len, int d, float eps) {
  constexpr int kRowsPerBlock = kWarpsPerBlock * (32 / T);
  const int q = threadIdx.x % T;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / T;
  const bool live = row < rows;  // dead lanes still join the shuffles
  const int nvec = d / 8;

  const __nv_bfloat16* xr = x + static_cast<size_t>(live ? row : 0) * d;
  float v[NV][8];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vec = q + i * T;
    if (live && vec < nvec) {
      load8(xr + vec * 8, v[i]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[i][j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) sum += v[i][j];
  }
  const float mean = team_sum<T>(sum) / d;

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const bool valid = q + i * T < nvec;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[i][j] = valid ? v[i][j] - mean : 0.f;
      sq += v[i][j] * v[i][j];
    }
  }
  const float var = team_sum<T>(sq) / d;
  const float rstd = rsqrtf(var + eps);
  if (!live) return;
  if (mean_out != nullptr && q == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }

  const int b = row / seq_len;
  __nv_bfloat16* yr = y + static_cast<size_t>(row) * d;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vec = q + i * T;
    if (vec >= nvec) continue;
    const int col = vec * 8;
    const float4 g0 = *reinterpret_cast<const float4*>(gamma + col);
    const float4 g1 = *reinterpret_cast<const float4*>(gamma + col + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(beta + col);
    const float4 b1 = *reinterpret_cast<const float4*>(beta + col + 4);
    const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float be[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    float out[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = v[i][j] * rstd * g[j] + be[j];
    if (shift != nullptr) {
      float sh[8], sc[8];
      load8(shift + static_cast<size_t>(b) * mod_stride + col, sh);
      load8(scale + static_cast<size_t>(b) * mod_stride + col, sc);
#pragma unroll
      for (int j = 0; j < 8; ++j) out[j] = out[j] * (1.f + sc[j]) + sh[j];
    }
    uint4 packed;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      h[j] = __floats2bfloat162_rn(out[2 * j], out[2 * j + 1]);
    }
    *reinterpret_cast<uint4*>(yr + col) = packed;
  }
}

template <int T, int NV>
cudaError_t launch(const __nv_bfloat16* x, const float* gamma,
                   const float* beta, const __nv_bfloat16* shift,
                   const __nv_bfloat16* scale, int mod_stride,
                   __nv_bfloat16* y, float* mean, float* rstd, int rows,
                   int seq_len, int d, float eps, cudaStream_t s) {
  constexpr int kRowsPerBlock = kWarpsPerBlock * (32 / T);
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  ln_modulate_fwd_kernel<T, NV><<<grid, kWarpsPerBlock * 32, 0, s>>>(
      x, gamma, beta, shift, scale, mod_stride, y, mean, rstd, rows, seq_len,
      d, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Any dtype and width (the entry point `ln_modulate_fwd_any`).
// ---------------------------------------------------------------------------

using sv_vec::kAnyMaxWidth;
using sv_vec::kLaneValues;
using sv_vec::load_vec;
using sv_vec::store_vec;

// The sum of v over the kW warps of a row (the warp's shuffles, then, for
// kW > 1, the warps' sums through `partial` in warp order). Every thread of
// the block calls it (the rows of a block run in step).
template <int kW>
__device__ __forceinline__ float row_sum(float v, float* partial) {
  v = team_sum<32>(v);
  if (kW == 1) return v;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) partial[warp] = v;
  __syncthreads();
  const int first = warp / kW * kW;
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kW; ++w) s += partial[first + w];
  return s;
}

// kW warps a row, kWarpsPerBlock / kW rows a block; lane q of a row's
// kW * 32 threads owns its vectors q, q + 32 kW, ... (kNV of them at most,
// kNV * VEC = kLaneValues), the last masked where they do not divide the
// row's d / VEC vectors.
template <typename E, int VEC, int kW>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ln_modulate_fwd_any_kernel(const E* __restrict__ x,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta,
                           const E* __restrict__ shift,
                           const E* __restrict__ scale, int mod_stride,
                           E* __restrict__ y, float* __restrict__ mean_out,
                           float* __restrict__ rstd_out, int rows,
                           int seq_len, int d, float eps) {
  constexpr int kTeam = kW * 32;
  constexpr int kNV = kLaneValues / VEC;
  constexpr int kRowsPerBlock = kWarpsPerBlock / kW;
  __shared__ float partial[2][kWarpsPerBlock];
  const int q = threadIdx.x % kTeam;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kTeam;
  const bool live = row < rows;  // dead rows still join the sums
  const int nvec = d / VEC;

  const E* xr = x + static_cast<size_t>(live ? row : 0) * d;
  float v[kNV][VEC];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kNV; ++i) {
    const int vec = q + i * kTeam;
    if (live && vec < nvec) {
      load_vec<E, VEC>(xr + vec * VEC, v[i]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[i][j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) sum += v[i][j];
  }
  const float mean = row_sum<kW>(sum, partial[0]) / d;

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kNV; ++i) {
    const bool valid = q + i * kTeam < nvec;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      v[i][j] = valid ? v[i][j] - mean : 0.f;
      sq += v[i][j] * v[i][j];
    }
  }
  const float var = row_sum<kW>(sq, partial[1]) / d;
  const float rstd = rsqrtf(var + eps);
  if (!live) return;
  if (mean_out != nullptr && q == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }

  const int b = row / seq_len;
  E* yr = y + static_cast<size_t>(row) * d;
#pragma unroll
  for (int i = 0; i < kNV; ++i) {
    const int vec = q + i * kTeam;
    if (vec >= nvec) continue;
    const int col = vec * VEC;
    float out[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      out[j] = v[i][j] * rstd * gamma[col + j] + beta[col + j];
    }
    if (shift != nullptr) {
      float sh[VEC], sc[VEC];
      load_vec<E, VEC>(shift + static_cast<size_t>(b) * mod_stride + col, sh);
      load_vec<E, VEC>(scale + static_cast<size_t>(b) * mod_stride + col, sc);
#pragma unroll
      for (int j = 0; j < VEC; ++j) out[j] = out[j] * (1.f + sc[j]) + sh[j];
    }
    store_vec<E, VEC>(yr + col, out);
  }
}

template <typename E, int VEC, int kW>
cudaError_t launch_any(const void* x, const void* gamma, const void* beta,
                       const void* shift, const void* scale, int mod_stride,
                       void* y, void* mean, void* rstd, int rows,
                       int seq_len, int d, float eps, cudaStream_t s) {
  constexpr int kRowsPerBlock = kWarpsPerBlock / kW;
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  ln_modulate_fwd_any_kernel<E, VEC, kW><<<grid, kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const E*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const E*>(shift),
      static_cast<const E*>(scale), mod_stride, static_cast<E*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), rows, seq_len, d,
      eps);
  return cudaGetLastError();
}

template <typename E, int VEC>
cudaError_t launch_any_width(const void* x, const void* gamma,
                             const void* beta, const void* shift,
                             const void* scale, int mod_stride, void* y,
                             void* mean, void* rstd, int rows, int seq_len,
                             int d, float eps, cudaStream_t s) {
  const int w = sv_vec::warps_a_row(d);
#define SV_LN_ANY_CASE(W)                                                   \
  if (w == W) {                                                             \
    return launch_any<E, VEC, W>(x, gamma, beta, shift, scale, mod_stride, \
                                 y, mean, rstd, rows, seq_len, d, eps, s); \
  }
  SV_LN_ANY_CASE(1)
  SV_LN_ANY_CASE(2)
  SV_LN_ANY_CASE(4)
  SV_LN_ANY_CASE(8)
#undef SV_LN_ANY_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// Widest row the kernel takes; any multiple of 32 up to it.
extern "C" int ln_modulate_max_width() { return kMaxWidth; }

// Widest row `ln_modulate_fwd_any` takes; every width from 1 up to it.
extern "C" int ln_modulate_any_max_width() { return kAnyMaxWidth; }

// K1 at any width from 1 to 8,192, in bf16 (f32 == 0) or f32 (f32 == 1):
// x, y: (rows = B*L, d) contiguous, and shift, scale: (B, d) rows
// `mod_stride` elements apart or both null, all in that dtype; gamma,
// beta: (d,) f32; mean, rstd: (rows,) f32 or both null. vec: the elements
// of a load (1, 2, 4, or 8 in bf16), which divides d and mod_stride and to
// which every pointer of x's dtype is aligned. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for another width or vector.
extern "C" int ln_modulate_fwd_any(const void* x, const void* gamma,
                                   const void* beta, const void* shift,
                                   const void* scale, int mod_stride, void* y,
                                   void* mean, void* rstd, int rows,
                                   int seq_len, int d, float eps, int f32,
                                   int vec, void* stream) {
  if (d < 1 || d > kAnyMaxWidth || vec < 1 || d % vec != 0 ||
      vec * (f32 ? 4 : 2) > 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SV_LN_ANY_VEC(E, V)                                                 \
  if (vec == V) {                                                           \
    return static_cast<int>(launch_any_width<E, V>(                         \
        x, gamma, beta, shift, scale, mod_stride, y, mean, rstd, rows,      \
        seq_len, d, eps, s));                                               \
  }
  if (f32) {
    SV_LN_ANY_VEC(float, 1)
    SV_LN_ANY_VEC(float, 2)
    SV_LN_ANY_VEC(float, 4)
  } else {
    SV_LN_ANY_VEC(__nv_bfloat16, 1)
    SV_LN_ANY_VEC(__nv_bfloat16, 2)
    SV_LN_ANY_VEC(__nv_bfloat16, 4)
    SV_LN_ANY_VEC(__nv_bfloat16, 8)
  }
#undef SV_LN_ANY_VEC
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, y: (rows = B*L, d) bf16, contiguous. gamma, beta: (d,) f32.
// shift, scale: (B, d) bf16 rows `mod_stride` elements apart, or both null.
// mean, rstd: (rows,) f32 or both null. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a width that is not a multiple of 32 in
// [32, 2048].
extern "C" int ln_modulate_fwd(const void* x, const void* gamma,
                               const void* beta, const void* shift,
                               const void* scale, int mod_stride, void* y,
                               void* mean, void* rstd, int rows, int seq_len,
                               int d, float eps, void* stream) {
  if (d < 32 || d > kMaxWidth || d % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* gf = static_cast<const float*>(gamma);
  const auto* bf = static_cast<const float*>(beta);
  const auto* sh = static_cast<const __nv_bfloat16*>(shift);
  const auto* sc = static_cast<const __nv_bfloat16*>(scale);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  auto* mf = static_cast<float*>(mean);
  auto* rf = static_cast<float*>(rstd);
  const int t = team_lanes(d);
  const int nv = (d / 8 + t - 1) / t;
#define SV_LN_CASE(T, NV)                                                  \
  if (t == T && nv == NV) {                                                \
    return static_cast<int>(launch<T, NV>(xb, gf, bf, sh, sc, mod_stride, \
                                          yb, mf, rf, rows, seq_len, d,   \
                                          eps, s));                       \
  }
  SV_LN_CASE(4, 1)
  SV_LN_CASE(8, 1)
  SV_LN_CASE(8, 2)
  SV_LN_CASE(16, 1)
  SV_LN_CASE(16, 2)
  SV_LN_CASE(32, 1)
  SV_LN_CASE(32, 2)
  SV_LN_CASE(32, 3)
  SV_LN_CASE(32, 4)
  SV_LN_CASE(32, 5)
  SV_LN_CASE(32, 6)
  SV_LN_CASE(32, 7)
  SV_LN_CASE(32, 8)
#undef SV_LN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
