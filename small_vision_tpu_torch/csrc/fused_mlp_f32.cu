// Fused MLP forward on f32 tensors: Dense, tanh-gelu, Dense, for Hopper
// (sm_90a). K5's f32 instance; fused_mlp.cu runs bf16.
//
// Replaces, for f32 inputs: small_vision_tpu/ops/fused_block.py::
// _mlp_kernel (reached via _mlp_pallas / fused_mlp under
// `dtype_mm="float32"`). The TPU kernel is generic in the dtype: its
// `.astype(x.dtype)` of the hidden activations is the identity in f32, so
// per row of x:
//   h = gelu_tanh(x W1 + b1)        (f32, flax's default tanh gelu)
//   y = h W2 + b2                   (f32)
//
// Bound on this card: operations. 4 rows d hidden operations: at the
// sampler's (64, 260), 768 wide with hidden 3,072, 157 GFLOP, 2.34 ms at
// 67 TFLOP/s of f32 FMA, against 121 MB of x, y and weights (0.036 ms at
// 3.35 TB/s).
//
// Design: two launches of simt_f32_gemm.cuh's SIMT GEMM (no wgmma
// instruction takes f32 x f32, and TF32 would not be f32): (a) the
// up-projection with the bias and the gelu on each f32 sum, into an f32
// (rows, hidden) scratch, (b) the down-projection with the bias. The
// scratch makes one round trip through device memory (2 x 204 MB at the
// sampler's shape, 0.12 ms at 3.35 TB/s, under the products' time). Any
// rows, width and hidden width, unpadded: the GEMM loads 16-byte vectors
// where the rows allow and scalars elsewhere. No split-K and no atomics,
// so two calls give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "simt_f32_gemm.cuh"

using simt_f32::Epilogue;

// (a): h (rows, hidden) = gelu_tanh(x W1 + b1); x (rows, width), W1
// (width, hidden), b1 (hidden,); f32, contiguous.
extern "C" int fused_mlp_f32_up(const void* x, const void* w1,
                                const void* b1, void* h, int rows, int width,
                                int hidden, void* stream) {
  const float* w[] = {static_cast<const float*>(w1)};
  const float* b[] = {static_cast<const float*>(b1)};
  return simt_f32::gemm_f32<Epilogue::kBiasGeluTanh, simt_f32::FusedMlp>(
      static_cast<const float*>(x), width, w, b, 1, static_cast<float*>(h),
      hidden, 0, rows, hidden, width, static_cast<cudaStream_t>(stream));
}

// (b): y (rows, width) = h W2 + b2; W2 (hidden, width), b2 (width,).
extern "C" int fused_mlp_f32_down(const void* h, const void* w2,
                                  const void* b2, void* y, int rows,
                                  int width, int hidden, void* stream) {
  const float* w[] = {static_cast<const float*>(w2)};
  const float* b[] = {static_cast<const float*>(b2)};
  return simt_f32::gemm_f32<Epilogue::kBias, simt_f32::FusedMlp>(
      static_cast<const float*>(h), hidden, w, b, 1, static_cast<float*>(y),
      width, 0, rows, width, hidden, static_cast<cudaStream_t>(stream));
}

// K5 in f32: (a) then (b) on `stream`, h the (rows, hidden) f32 scratch.
// Returns cudaGetLastError() after each launch, or cudaErrorInvalidValue
// for a shape the GEMM does not take.
extern "C" int fused_mlp_f32_fwd(const void* x, const void* w1,
                                 const void* b1, const void* w2,
                                 const void* b2, void* h, void* y, int rows,
                                 int width, int hidden, void* stream) {
  const int status =
      fused_mlp_f32_up(x, w1, b1, h, rows, width, hidden, stream);
  if (status != 0) return status;
  return fused_mlp_f32_down(h, w2, b2, y, rows, width, hidden, stream);
}
