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
// Design: one warp per row, so the row's reductions are warp shuffles and
// no shared memory or block barrier is needed. Each lane holds D/32
// elements in registers, loaded and stored as 16-byte vectors (8 bf16) at
// addresses that neighbouring lanes make contiguous, so every load and store
// is a full coalesced transaction. x is read once; the centred values stay
// in registers for the variance pass, as the TPU kernel's two-pass
// mean((x - mean)^2) does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
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

// D = NV * 256: lane `lane` owns columns (i * 32 + lane) * 8 .. + 7.
template <int NV>
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
                       int rows, int seq_len, float eps) {
  constexpr int D = NV * 256;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;

  const __nv_bfloat16* xr = x + static_cast<size_t>(row) * D;
  float v[NV][8];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    load8(xr + (i * 32 + lane) * 8, v[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) sum += v[i][j];
  }
  const float mean = warp_sum(sum) / D;

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[i][j] -= mean;
      sq += v[i][j] * v[i][j];
    }
  }
  const float var = warp_sum(sq) / D;
  const float rstd = rsqrtf(var + eps);
  if (mean_out != nullptr && lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }

  const int b = row / seq_len;
  __nv_bfloat16* yr = y + static_cast<size_t>(row) * D;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = (i * 32 + lane) * 8;
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

}  // namespace

// x, y: (rows = B*L, d) bf16, contiguous. gamma, beta: (d,) f32.
// shift, scale: (B, d) bf16 rows `mod_stride` elements apart, or both null.
// mean, rstd: (rows,) f32 or both null. Returns cudaGetLastError().
extern "C" int ln_modulate_fwd(const void* x, const void* gamma,
                               const void* beta, const void* shift,
                               const void* scale, int mod_stride, void* y,
                               void* mean, void* rstd, int rows, int seq_len,
                               int d, float eps, void* stream) {
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* gf = static_cast<const float*>(gamma);
  const auto* bf = static_cast<const float*>(beta);
  const auto* sh = static_cast<const __nv_bfloat16*>(shift);
  const auto* sc = static_cast<const __nv_bfloat16*>(scale);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  auto* mf = static_cast<float*>(mean);
  auto* rf = static_cast<float*>(rstd);
  switch (d) {  // The widths of UMD-B and UMD-L.
    case 768:
      ln_modulate_fwd_kernel<3><<<grid, block, 0, s>>>(
          xb, gf, bf, sh, sc, mod_stride, yb, mf, rf, rows, seq_len, eps);
      break;
    case 1024:
      ln_modulate_fwd_kernel<4><<<grid, block, 0, s>>>(
          xb, gf, bf, sh, sc, mod_stride, yb, mf, rf, rows, seq_len, eps);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
