// Packed (B, L, H*D) bf16 attention under one of seven softmax / matmul
// arms, forward only, for Hopper (sm_90a), at any head dim D that is a
// multiple of 8 up to 2,048: the ablation kernel that tells where the time
// of the attention core goes that K6 and K7 run.
//
// Replaces: scripts/ablate_attention_kernel.py::_kernel_variant (reached via
// run_variant). With S = (Q K^T) * scale in f32 and lp = L rounded up to 16
// (the TPU tile; its columns past L hold keys that are zero, so they score
// exactly 0), each arm computes its JAX arm's function:
//   prod       S masked to -inf past L; m = rowmax; e = exp(S - m);
//              p = bf16(e / rowsum(e))
//   nosoftmax  p = bf16(S * 0.001), no mask (keys past L are zero rows)
//   nomm       no QK product: S[i][j] = f32(bf16(q[i][0] * scale)) for every
//              j, then prod's softmax; out[i][:] = bf16(p[i][0] * v[i][0])
//              on all D columns of the head (query row i's own v)
//   bf16exp    prod with e = bf16(exp(bf16(S - m))), summed in f32
//   exp2       S * log2(e), masked; e = exp2(S - m)
//   mulmask    m = rowmax over all lp columns (a 0 joins the max when L is
//              not a multiple of 16); e = exp(S - m) * [key < L]
//   nomax      e = exp(S) * [key < L], unshifted
// Every arm but nosoftmax divides e by its f32 row sum (as a product with
// its reciprocal), and every arm rounds p to bf16 before the PV product,
// which accumulates in f32. bf16exp: exp is taken in f32 of the rounded
// argument and its result rounded to bf16, which is how a CPU evaluates the
// bf16 exp.
//
// Bound on this card: at B=128, H=12, L=257 the 4*B*L*768*2 bytes of q, k,
// v and o (202 MB, 0.060 ms at 3.35 TB/s) outweigh the 4*B*H*L^2*64 flops
// (26 GFLOP, 0.026 ms at 989 TFLOP/s); the exp of every score, taken once
// for the row sum and once for p, is the next limit.
//
// Design: each arm is a softmax policy of the max-shift attention core of
// sm90_attention.cuh (wgmma products, K and V resident in 64-row TMA
// tiles or, for long heads, streamed through a ring of them, each pass
// walking the keys again; a head one to four 64-column tiles, or past 256
// the core's wide path; two passes;
// the scale is f32(D**-0.5), as the TPU kernel rounds it), one change from
// its production policy, so the tool measures that core. exp2 is the
// production instantiation itself (K6, K7); prod differs from it by expf
// in the natural base; nosoftmax runs one pass and no softmax; nomm
// issues no product and loads no K; bf16exp runs a pass for the max alone,
// then the sum, then p (a running rescale of a sum of rounded e is not the
// sum of the e that are normalised); mulmask bounds its max at lp, not at
// the 64-row tile, whose further zero keys the JAX arm never sees; nomax
// drops the max.

#include "sm90_attention.cuh"

namespace {

enum Arm {
  kProd = 0,
  kNoSoftmax = 1,
  kNoMM = 2,
  kBf16Exp = 3,
  kExp2 = 4,
  kMulMask = 5,
  kNoMax = 6,
};

template <class P, int kGroups, int NT, bool kStream>
__global__ void __launch_bounds__(128 * kGroups, (NT == 1 ? 4 : 2) / kGroups)
attention_ablate_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const sm90::AttnArgs a) {
  extern __shared__ uint8_t smem_raw[];
  sm90::attention_heads<P, kGroups, NT, kStream>(smem_raw, &tm_q, &tm_k,
                                                 &tm_v, a);
}

template <class P>
__global__ void __launch_bounds__(128, 2)
attention_ablate_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const sm90::AttnArgs a, int chunk_tiles) {
  extern __shared__ uint8_t smem_raw[];
  sm90::attention_wide<P>(smem_raw, &tm_q, &tm_k, &tm_v, a, chunk_tiles);
}

template <class P>
int launch(const CUtensorMap (&tm)[3], const sm90::AttnArgs& args, int batch,
           int num_heads, cudaStream_t stream) {
  using Kernel = decltype(&attention_ablate_kernel<P, 1, 1, false>);
  const Kernel kernels[4][3] = {
      {attention_ablate_kernel<P, 1, 1, false>,
       attention_ablate_kernel<P, 2, 1, false>,
       attention_ablate_kernel<P, 2, 1, true>},
      {attention_ablate_kernel<P, 1, 2, false>,
       attention_ablate_kernel<P, 2, 2, false>,
       attention_ablate_kernel<P, 2, 2, true>},
      {attention_ablate_kernel<P, 2, 3, true>,
       attention_ablate_kernel<P, 2, 3, true>,
       attention_ablate_kernel<P, 2, 3, true>},
      {attention_ablate_kernel<P, 2, 4, true>,
       attention_ablate_kernel<P, 2, 4, true>,
       attention_ablate_kernel<P, 2, 4, true>}};
  return sm90_host::launch_attention<P>(kernels,
                                        attention_ablate_wide_kernel<P>,
                                        tm[0], tm[1], tm[2], args, batch,
                                        num_heads, stream);
}

}  // namespace

// Largest head dim the kernel takes; any multiple of 8 up to it.
extern "C" int attention_ablate_max_head_dim() {
  return sm90::kAttnMaxHeadDim;
}

// Largest sequence length the kernel takes at a head dim: 4,096 at every
// one (K and V stream past the resident limit).
extern "C" int attention_ablate_max_len(int head_dim) {
  return sm90::attn_max_len(head_dim);
}

// q, k, v, o: (B, L, H*D) bf16, contiguous, 16-byte aligned; D a multiple
// of 8 up to 2,048, L up to 4,096. scale = D**-0.5 in f32. variant: 0 prod,
// 1 nosoftmax, 2 nomm, 3 bf16exp, 4 exp2, 5 mulmask, 6 nomax. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unknown variant, a
// head dim or a length past the limits or a tensor map that cannot be
// encoded.
extern "C" int attention_ablate_fwd(const void* q, const void* k,
                                    const void* v, void* o, int batch,
                                    int seq_len, int num_heads, int head_dim,
                                    float scale, int variant, void* stream) {
  if (!sm90_host::valid_head_dim(head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tm[3];
  const void* src[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    if (!sm90_host::packed_head_map_d(&tm[i], src[i], batch, seq_len,
                                      num_heads, head_dim)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const sm90::AttnArgs args{0, 0, 0, static_cast<__nv_bfloat16*>(o),
                            num_heads * head_dim, seq_len, head_dim, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kProd:
      return launch<sm90::SoftmaxExp>(tm, args, batch, num_heads, st);
    case kNoSoftmax:
      return launch<sm90::NoSoftmax>(tm, args, batch, num_heads, st);
    case kNoMM:
      return launch<sm90::NoMatmul>(tm, args, batch, num_heads, st);
    case kBf16Exp:
      return launch<sm90::Bf16Exp>(tm, args, batch, num_heads, st);
    case kExp2:
      return launch<sm90::SoftmaxExp2>(tm, args, batch, num_heads, st);
    case kMulMask:
      return launch<sm90::MulMask>(tm, args, batch, num_heads, st);
    case kNoMax:
      return launch<sm90::NoMax>(tm, args, batch, num_heads, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
