// Packed attention with the clamped exp2 softmax in f32, forward (K3) and
// backward (K4), for Hopper (sm_90a).
//
// Replaces, for f32 inputs: small_vision_tpu/ops/attention.py::
// pallas_attention_packed (`_attn_kernel_packed`) and
// _pallas_attention_packed_bwd_impl (`_attn_bwd_kernel_packed`). The TPU
// kernels are generic in the inputs' dtype (they round e, dS, dO r and Q r
// scale to it, a no-op in f32), and `dtype_mm="float32"` runs them in f32;
// the bf16 kernels of attention_packed.cu and attention_packed_bwd.cu run
// bf16 only. On (B, L, H*D) f32 tensors, per batch row and head:
//   s = (q k^T) * scale2 (scale2 = D**-0.5 log2(e), rounded to f32)
//   e = exp2(clamp(s, -80, 80)), 0 for keys past L
//   o = (e v) / rowsum(e)
// and its backward, formula by formula as the TPU kernel's:
//   r = 1 / rowsum(e) (0 for queries past L); dV = e^T (dO r)
//   dP = dO v^T; c = rowsum(dP e) r; dS = e (dP - c)
//   dQ = (dS k) r scale; dK = dS^T (q r scale)
//
// Bound on this card: operations. The forward's two products are 4 B H
// L^2 D operations, taken as nine TF32 passes of 2 B H L^2 D on the tensor
// cores (the scores six, e V three), the backward's five 10 B H L^2 D,
// three passes each (3xTF32): 0.121 ms for the forward at the sampler's
// (64, 260), 768 wide, and 0.39 ms for the backward at (128, 257), at 495
// TFLOP/s.
//
// Design: the forward is sm90_f32x3_attention.cuh under the `ClampExp2`
// policy (the clamp bounds e, so it needs no max and no rescaling), the
// backward sm90_f32x3_attention_bwd.cuh under the same policy (three
// kernels: row statistics, dQ, dK with dV). Both take their products on
// wgmma in TF32 passes (the backward's and the forward's e V 3xTF32, the
// forward's scores finer) and every sum in a fixed order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_f32x3.cuh"
#include "sm90_f32x3_attention.cuh"
#include "sm90_f32x3_attention_bwd.cuh"

// Longest sequence and widest head the f32 kernels take (every length and
// head dim from 1 up to them).
extern "C" int attention_packed_f32_max_len() { return f32x3::kMaxLen; }
extern "C" int attention_packed_f32_max_head_dim() {
  return f32x3::kMaxHeadDim;
}

// K3 in f32. q, k, v, o: (B, L, H*D) f32, contiguous. scale2: D**-0.5 *
// log2(e), rounded to f32. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int attention_packed_f32_fwd(const void* q, const void* k,
                                        const void* v, void* o, int batch,
                                        int len, int heads, int d,
                                        float scale2, void* stream) {
  return f32x3::attn_forward<f32x3::ClampExp2>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), batch, len,
      heads, d, scale2, static_cast<cudaStream_t>(stream));
}

// K4 in f32: three kernels on `stream`, the row statistics (into r and c,
// (B, H, L) f32 scratch), dQ, and dK with dV. q, k, v, dout, dq, dk, dv:
// (B, L, H*D) f32, contiguous. scale2 as K3's; scale: D**-0.5 rounded to
// f32. Returns cudaGetLastError() after each launch, or
// cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int attention_packed_f32_bwd(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        void* dq, void* dk, void* dv,
                                        void* r, void* c, int batch, int len,
                                        int heads, int d, float scale2,
                                        float scale, void* stream) {
  return f32x3::attn_backward<f32x3::ClampExp2>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), nullptr, static_cast<float*>(r),
      static_cast<float*>(c), batch, len, heads, d, scale2, scale,
      f32x3::kBwdAll, static_cast<cudaStream_t>(stream));
}
