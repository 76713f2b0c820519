// Fused MLP forward on bf16 tensors: Dense, tanh-gelu, Dense, for Hopper
// (sm_90a).
//
// Replaces: small_vision_tpu/ops/fused_block.py::_mlp_kernel (reached via
// _mlp_pallas / fused_mlp). Per row of x:
//   h = bf16(gelu_tanh(f32(x W1) + b1))        (f32 sums, f32 gelu)
//   y = bf16(f32(h W2) + b2)                   (f32 sums, one rounding)
// the TPU kernel's rounding points.
//
// Bound on this card: at the sampler's shape (16,640 rows, width 768,
// hidden 3,072) the 4*rows*768*3072 = 157 GFLOP take 0.159 ms at 989
// TFLOP/s, against 60.6 MB of x, y and weights (0.018 ms at 3.35 TB/s):
// the floor is the tensor cores.
//
// Design. The TPU kernel keeps h and the weights in VMEM. One kernel here
// cannot keep h on chip without a small row tile: a 128-row tile's f32
// output accumulator at width 768 is 384 KB, more than an SM's registers
// or shared memory, and a 64-row tile streams all 9.4 MB of weights through
// shared memory again for every tile (2.4 GB from the L2 at the sampler's
// shape). So h makes one round trip through device memory as bf16, the TPU
// kernel's own rounding point, which changes no bit: 2 x 102 MB at the
// sampler's shape, 0.061 ms at 3.35 TB/s, under the products' time. Two
// launches of the persistent wgmma GEMM of sm90_gemm.cuh
// (`gemm_bias_tiles`, its design there):
//  (a) fused_mlp_up_kernel: h = bf16(gelu_tanh(f32(x W1) + b1)), M = rows,
//      K = width, N = hidden; bias and gelu on the f32 accumulator before
//      the rounding (`BiasGeluTanh`: one ex2 and one reciprocal a value);
//  (b) fused_mlp_down_kernel: y = bf16(f32(h W2) + b2), M = rows, K =
//      hidden, N = width.
// No split-K and no atomics, so two calls give the same bits. The width
// and the hidden width are any multiples of 8 (the GEMM takes tails along
// K and N, zero-filled by TMA; ViT-mu's 32 -> 128 -> 32 is one stage of
// 64 whose upper half is zeros), the rows any count. The wrapper
// (ops/fused_block.py) zero-pads other widths to multiples of 8.
//
// Tiles: 128 x 128, a ring of 5 stages 64 deep, one CTA a SM, for both.
// The up-projection runs the ping-pong schedule: its K is the width (12
// stages a tile at 768), so the epilogue (two SFU operations a value, 51 M
// values at the sampler's shape) would stall the tensor cores for a large
// share of every tile if both warpgroups shared it; each warpgroup taking
// whole tiles in turn hides it (0.137 against 0.153 ms at the sampler's
// shape on the H100). The down-projection, 48 stages a tile and a bias
// alone in its epilogue, gains nothing from it and stays cooperative.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

namespace {

using UpTiles = sm90::GemmTiles<true>;     // ping-pong
using DownTiles = sm90::GemmTiles<false>;  // cooperative

// h (rows, hidden) = bf16(gelu_tanh(f32(x W1) + b1)).
__global__ void __launch_bounds__(sm90::kGemmThreads, 1)
fused_mlp_up_kernel(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_w1,
                    const __grid_constant__ CUtensorMap tm_h,
                    const __nv_bfloat16* __restrict__ b1, int rows,
                    int hidden, int width) {
  extern __shared__ uint8_t smem_raw[];
  sm90::gemm_bias_tiles<sm90::BiasGeluTanh, UpTiles>(
      smem_raw, &tm_x, &tm_w1, &tm_w1, &tm_w1, &tm_h, &tm_h, &tm_h, b1, b1,
      b1, rows, hidden, width, 1);
}

// y (rows, width) = bf16(f32(h W2) + b2).
__global__ void __launch_bounds__(sm90::kGemmThreads, 1)
fused_mlp_down_kernel(const __grid_constant__ CUtensorMap tm_h,
                      const __grid_constant__ CUtensorMap tm_w2,
                      const __grid_constant__ CUtensorMap tm_y,
                      const __nv_bfloat16* __restrict__ b2, int rows,
                      int width, int hidden) {
  extern __shared__ uint8_t smem_raw[];
  sm90::gemm_bias_tiles<sm90::BiasOnly, DownTiles>(
      smem_raw, &tm_h, &tm_w2, &tm_w2, &tm_w2, &tm_y, &tm_y, &tm_y, b2, b2,
      b2, rows, width, hidden, 1);
}

// c (m, n) = kernel's bf16(Epi(f32(a w) + b)): a (m, k), w (k, n), b (n,),
// row-major bf16; k and n multiples of 8.
template <class T, class Kernel>
int launch(Kernel kernel, const void* a, const void* w, const void* b,
           void* c, int m, int n, int k, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || n % 8 != 0 || k % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap ta, tw, tc;
  if (!sm90_host::matrix_map(&ta, a, m, k, k, T::kBM) ||
      !sm90_host::matrix_map(&tw, w, k, n, n, T::kBK) ||
      !sm90_host::matrix_map(&tc, c, m, n, n, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (m + T::kBM - 1) / T::kBM * ((n + T::kBN - 1) / T::kBN);
  const int sms = sm90_host::sm_count();
  kernel<<<tiles < sms ? tiles : sms, sm90::kGemmThreads, T::kSmem,
           static_cast<cudaStream_t>(stream)>>>(
      ta, tw, tc, static_cast<const __nv_bfloat16*>(b), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (a): h (rows, hidden) = bf16(gelu_tanh(f32(x w1) + b1)); x (rows,
// width), w1 (width, hidden), b1 (hidden,). All bf16, contiguous, 16-byte
// aligned; width and hidden multiples of 8. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape it does not take or a tensor map the
// driver refuses.
extern "C" int fused_mlp_up(const void* x, const void* w1, const void* b1,
                            void* h, int rows, int width, int hidden,
                            void* stream) {
  return launch<UpTiles>(fused_mlp_up_kernel, x, w1, b1, h, rows, hidden,
                         width, stream);
}

// (b): y (rows, width) = bf16(f32(h w2) + b2); h (rows, hidden), w2
// (hidden, width), b2 (width,); as (a).
extern "C" int fused_mlp_down(const void* h, const void* w2, const void* b2,
                              void* y, int rows, int width, int hidden,
                              void* stream) {
  return launch<DownTiles>(fused_mlp_down_kernel, h, w2, b2, y, rows, width,
                           hidden, stream);
}

// x, y: (rows, width); w1: (width, hidden), b1: (hidden,), w2: (hidden,
// width), b2: (width,); h: (rows, hidden) scratch. All bf16, contiguous,
// 16-byte aligned; width and hidden multiples of 8. The two launches (a),
// (b); returns the first non-zero status.
extern "C" int fused_mlp_fwd(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* h, void* y,
                             int rows, int width, int hidden, void* stream) {
  const int status = fused_mlp_up(x, w1, b1, h, rows, width, hidden, stream);
  if (status != 0) return status;
  return fused_mlp_down(h, w2, b2, y, rows, width, hidden, stream);
}
