// Attention on [B, L, H, D] with the max-shift softmax in f32, forward (K7)
// and backward (K8), for Hopper (sm_90a).
//
// Replaces, for f32 inputs: small_vision_tpu/ops/attention.py::
// pallas_attention (`_attn_kernel`) and _pallas_attention_bwd_impl
// (`_attn_bwd_kernel`). The TPU kernels are generic in the inputs' dtype
// (they round the probabilities and dS to it, a no-op in f32); the bf16
// kernels of attention_unpacked.cu and attention_unpacked_bwd.cu run bf16
// only. Per batch row and head, with scale = D**-0.5:
//   p = softmax(q k^T scale), the row max subtracted, keys past L -inf
//   o = p v
// and its backward, formula by formula as the TPU kernel's:
//   dV = p^T dO; dP = dO v^T; dS = p (dP - rowsum(dP p))
//   dQ = dS k scale; dK = dS^T q scale
// computed as exp2 of the log2(e)-scaled scores less their row max, with p
// = e r, r = 1 / rowsum(e) (sm90_f32x3_attention_bwd.cuh's formulas).
//
// A contiguous [B, L, H, D] tensor is the packed (B, L, H*D) one in
// memory, so the kernels read heads in place.
//
// Bound on this card: operations. A forward's two products are 4 B H L^2 D
// operations, taken as nine TF32 passes of 2 B H L^2 D on the tensor
// cores (the scores six, e V three), a backward's five 10 B H L^2 D, three
// passes each (3xTF32): 0.121 ms for the forward at (64, 260) with 12
// heads of 64, 0.39 ms for the backward at (128, 257), at 495 TFLOP/s.
//
// Design: the forward is sm90_f32x3_attention.cuh under the `MaxShift`
// policy (a running row max, the sums rescaled: online softmax; the
// scores a pair finer than f32, so t - m is rounded once, near 0, where
// a key nears the max), the backward sm90_f32x3_attention_bwd.cuh under
// the same policy (K4 f32's three kernels), with the max-shift
// statistics m and r (and c) from the first. Both take their products
// on wgmma in TF32 passes and every sum in a fixed order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_f32x3.cuh"
#include "sm90_f32x3_attention.cuh"
#include "sm90_f32x3_attention_bwd.cuh"

// Longest sequence and widest head the f32 kernels take (every length and
// head dim from 1 up to them).
extern "C" int attention_unpacked_f32_max_len() { return f32x3::kMaxLen; }
extern "C" int attention_unpacked_f32_max_head_dim() {
  return f32x3::kMaxHeadDim;
}

// K7 in f32. q, k, v, o: [B, L, H, D] f32, contiguous. scale2: D**-0.5 *
// log2(e), rounded to f32. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int attention_unpacked_f32_fwd(const void* q, const void* k,
                                          const void* v, void* o, int batch,
                                          int len, int heads, int d,
                                          float scale2, void* stream) {
  return f32x3::attn_forward<f32x3::MaxShift>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), batch, len,
      heads, d, scale2, static_cast<cudaStream_t>(stream));
}

// K8 in f32: three kernels on `stream` (or the one `stage` names: 0 the row
// statistics, 1 dQ, 2 dK and dV; -1 all three in turn): the statistics into
// m (the row max of the log2(e)-scaled scores), r (1 / the row sum) and c
// (the row sum of dP p), (B, H, L) f32 scratch, then dQ, then dK with dV.
// q, k, v, dout, dq, dk, dv: [B, L, H, D] f32, contiguous. scale2 as K7's;
// scale: D**-0.5 rounded to f32. Returns cudaGetLastError() after each
// launch, or cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int attention_unpacked_f32_bwd_stage(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, void* m, void* r, void* c, int batch, int len,
    int heads, int d, float scale2, float scale, int stage, void* stream) {
  return f32x3::attn_backward<f32x3::MaxShift>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<float*>(m),
      static_cast<float*>(r), static_cast<float*>(c), batch, len, heads, d,
      scale2, scale, stage, static_cast<cudaStream_t>(stream));
}

extern "C" int attention_unpacked_f32_bwd(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          void* dq, void* dk, void* dv,
                                          void* m, void* r, void* c,
                                          int batch, int len, int heads,
                                          int d, float scale2, float scale,
                                          void* stream) {
  return attention_unpacked_f32_bwd_stage(q, k, v, dout, dq, dk, dv, m, r,
                                          c, batch, len, heads, d, scale2,
                                          scale, f32x3::kBwdAll, stream);
}
