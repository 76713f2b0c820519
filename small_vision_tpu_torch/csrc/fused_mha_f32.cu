// Fused multi-head self-attention forward on f32 tensors, for Hopper
// (sm_90a): the q, k, v projections, the max-shift softmax attention and
// the out-projection. K6's f32 instance; fused_mha.cu runs bf16.
//
// Replaces, for f32 inputs: small_vision_tpu/ops/fused_block.py::
// _mha_kernel (reached via _mha_pallas / fused_mha under
// `dtype_mm="float32"`). The TPU kernel is generic in the dtype (its
// `.astype(xi.dtype)` roundings of q, k, v, the probabilities and the head
// outputs are the identity in f32). On x (B, L, d), W_q, W_k, W_v (d, H*D)
// with (H*D,) biases, W_o (H*D, d) with a (d,) bias, f32:
//   q, k, v = x W + b
//   per head: p = softmax(q k^T D**-0.5), the row max subtracted
//   o = concat_h(p v) W_o + b_o
// d = H*D in one process, and a tensor rank's H heads of a wider model
// under the Megatron block (d != H*D).
//
// Bound on this card: operations. 8 B L d H*D for the four projections and
// 4 B H L^2 D for the attention: at the sampler's (64, 260), 768 wide in 12
// heads of 64, 78.5 + 13.3 GFLOP, 1.37 ms at 67 TFLOP/s of f32 FMA.
//
// Design: three launches, as the bf16 K6: (a) the q, k, v projections, one
// launch of simt_f32_gemm.cuh's SIMT GEMM over three weights (gridDim.z)
// into one (B, L, 3 H*D) buffer, q, k and v side by side; (b) the
// attention of simt_f32_attention.cuh under the `MaxShift` policy (online
// softmax, D in chunks of 32, every head dim from 1 to 2,048, L up to
// 4,096), reading q, k and v in place at their row stride 3 H*D, into the
// (B, L, H*D) head outputs; (c) the out-projection, the same GEMM. The
// scores and the probabilities never reach device memory. Any width and
// head dim, unpadded. No atomics: two launches give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "simt_f32_attention.cuh"
#include "simt_f32_gemm.cuh"
#include "sm90_f32x3.cuh"

using simt_f32::Epilogue;

// Longest sequence and widest head the attention takes (every length and
// head dim from 1 up to them).
extern "C" int fused_mha_f32_max_len() { return f32x3::kMaxLen; }
extern "C" int fused_mha_f32_max_head_dim() { return f32x3::kMaxHeadDim; }

// (a) and (c): c (m, num_w * n) = [a w_i + b_i for i < num_w] side by side;
// a (m, k), each w_i (k, n), b_i (n,); f32, contiguous; num_w 1 to 3
// (unused w_i, b_i are ignored).
extern "C" int fused_mha_f32_proj(const void* a, const void* w0,
                                  const void* w1, const void* w2,
                                  const void* b0, const void* b1,
                                  const void* b2, void* c, int m, int n,
                                  int k, int num_w, void* stream) {
  const float* w[] = {static_cast<const float*>(w0),
                      static_cast<const float*>(w1),
                      static_cast<const float*>(w2)};
  const float* b[] = {static_cast<const float*>(b0),
                      static_cast<const float*>(b1),
                      static_cast<const float*>(b2)};
  if (num_w < 1 || num_w > 3) return static_cast<int>(cudaErrorInvalidValue);
  return simt_f32::gemm_f32<Epilogue::kBias, simt_f32::FusedMha>(
      static_cast<const float*>(a), k, w, b, num_w, static_cast<float*>(c),
      num_w * n, n, m, n, k, static_cast<cudaStream_t>(stream));
}

// (b): heads (B, L, H*D) = the attention of qkv (B, L, 3 H*D), q, k and v
// side by side; scale2 = D**-0.5 log2(e), rounded to f32.
extern "C" int fused_mha_f32_attention(const void* qkv, void* heads,
                                       int batch, int seq_len, int num_heads,
                                       int head_dim, float scale2,
                                       void* stream) {
  const int hd = num_heads * head_dim;
  const float* q = static_cast<const float*>(qkv);
  return simt_f32::attn_f32_forward<f32x3::MaxShift>(
      q, q + hd, q + 2 * hd, static_cast<float*>(heads), batch, seq_len,
      num_heads, head_dim, 3 * hd, hd, scale2,
      static_cast<cudaStream_t>(stream));
}

// K6 in f32: (a), (b), (c) on `stream`. x (B, L, width); wq, wk, wv (width,
// H*D); bq, bk, bv (H*D,); wo (H*D, width); bo (width,); qkv (B, L, 3 H*D)
// and heads (B, L, H*D) f32 scratch; o (B, L, width). Returns
// cudaGetLastError() after each launch, or cudaErrorInvalidValue for a
// shape the kernels do not take.
extern "C" int fused_mha_f32_fwd(const void* x, const void* wq,
                                 const void* bq, const void* wk,
                                 const void* bk, const void* wv,
                                 const void* bv, const void* wo,
                                 const void* bo, void* qkv, void* heads,
                                 void* o, int batch, int seq_len, int width,
                                 int num_heads, int head_dim, float scale2,
                                 void* stream) {
  if (!f32x3::attn_takes(batch, seq_len, num_heads, head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = batch * seq_len, hd = num_heads * head_dim;
  int status = fused_mha_f32_proj(x, wq, wk, wv, bq, bk, bv, qkv, rows, hd,
                                  width, 3, stream);
  if (status != 0) return status;
  status = fused_mha_f32_attention(qkv, heads, batch, seq_len, num_heads,
                                   head_dim, scale2, stream);
  if (status != 0) return status;
  return fused_mha_f32_proj(heads, wo, wo, wo, bo, bo, bo, o, rows, width,
                            hd, 1, stream);
}
