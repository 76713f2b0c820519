// Bidirectional attention on [B, L, H, D] bf16 tensors with the max-shift
// softmax, forward, for Hopper (sm_90a), at any head dim D that is a
// multiple of 8 up to 2,048.
//
// Replaces: small_vision_tpu/ops/attention.py::_attn_kernel (reached via
// pallas_attention / fused_attention). Per (batch, head):
//   S = (Q K^T) * scale, keys past L masked                 (f32)
//   p = bf16(exp(S - rowmax(S)) / rowsum(exp(S - rowmax(S))))
//   O = bf16(p V)                                           (f32 sums)
// the TPU kernel's rounding points: the probabilities are normalised in
// f32 and rounded before the PV product. It differs from the packed
// kernel (attention_packed.cu) in each of them: that one clamps instead of
// shifting, rounds the unnormalised e and divides the output.
//
// Bound on this card: at B=64, H=12, L=260 the 4*B*L*H*64*2 bytes of q, k,
// v and o (102 MB, 0.031 ms at 3.35 TB/s) outweigh the 4*B*H*L^2*64 flops
// (13 GFLOP, 0.013 ms at 989 TFLOP/s): the floor is memory, and the two
// exp of every score (one in each pass) are the next limit.
//
// Design: a contiguous [B, L, H, D] tensor is the packed (B, L, H*D)
// one, so the kernel reads heads in place through three tensor maps (one
// each over q, k and v, viewed as (D, H, L, B) and bounded at D and L) and
// writes o with row stride H*D; the TPU wrapper's transposes and pads have
// no counterpart. It runs the max-shift attention core of
// sm90_attention.cuh (wgmma products, K and V resident in TMA tiles or,
// past 320 keys at D <= 64 and 384 up to 128, and at every length above,
// streamed through a ring of them, up to L = 4,096; a head one to four
// 64-column tiles, or past 256 its wide path, S summed over the head's
// tiles through a ring of tile pairs and O's columns split across CTAs)
// under its production
// softmax, the one K6's attention stage runs: exp becomes exp2 of the
// log2(e)-scaled score, the same function within two bf16 ulps of the
// output. The scale is f32(D**-0.5), as the TPU kernel rounds it.

#include "sm90_attention.cuh"

namespace {

template <int kGroups, int NT, bool kStream>
__global__ void __launch_bounds__(128 * kGroups, (NT == 1 ? 4 : 2) / kGroups)
attention_unpacked_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const sm90::AttnArgs a) {
  extern __shared__ uint8_t smem_raw[];
  sm90::attention_heads<sm90::SoftmaxExp2, kGroups, NT, kStream>(
      smem_raw, &tm_q, &tm_k, &tm_v, a);
}

// Head dims past 256 (sm90::attention_wide): O's `chunk_tiles` column
// tiles a CTA.
__global__ void __launch_bounds__(128, 2)
attention_unpacked_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const sm90::AttnArgs a, int chunk_tiles) {
  extern __shared__ uint8_t smem_raw[];
  sm90::attention_wide<sm90::SoftmaxExp2>(smem_raw, &tm_q, &tm_k, &tm_v, a,
                                          chunk_tiles);
}

}  // namespace

// Largest head dim the kernel takes; any multiple of 8 up to it.
extern "C" int attention_unpacked_max_head_dim() {
  return sm90::kAttnMaxHeadDim;
}

// Largest sequence length the kernel takes at a head dim: 4,096 at every
// one (K and V stream past the resident limit; K8 takes as much).
extern "C" int attention_unpacked_max_len(int head_dim) {
  return sm90::attn_max_len(head_dim);
}

namespace {

int run(const void* q, const void* k, const void* v, void* o, int batch,
        int seq_len, int num_heads, int head_dim, float scale, bool stream_kv,
        int chunk_tiles, void* stream) {
  if (!sm90_host::valid_head_dim(head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tq, tk, tv;
  if (!sm90_host::packed_head_map_d(&tq, q, batch, seq_len, num_heads,
                                    head_dim) ||
      !sm90_host::packed_head_map_d(&tk, k, batch, seq_len, num_heads,
                                    head_dim) ||
      !sm90_host::packed_head_map_d(&tv, v, batch, seq_len, num_heads,
                                    head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const sm90::AttnArgs args{0, 0, 0, static_cast<__nv_bfloat16*>(o),
                            num_heads * head_dim, seq_len, head_dim, scale};
  using Kernel = decltype(&attention_unpacked_fwd_kernel<1, 1, false>);
  const Kernel kernels[4][3] = {
      {attention_unpacked_fwd_kernel<1, 1, false>,
       attention_unpacked_fwd_kernel<2, 1, false>,
       attention_unpacked_fwd_kernel<2, 1, true>},
      {attention_unpacked_fwd_kernel<1, 2, false>,
       attention_unpacked_fwd_kernel<2, 2, false>,
       attention_unpacked_fwd_kernel<2, 2, true>},
      {attention_unpacked_fwd_kernel<2, 3, true>,
       attention_unpacked_fwd_kernel<2, 3, true>,
       attention_unpacked_fwd_kernel<2, 3, true>},
      {attention_unpacked_fwd_kernel<2, 4, true>,
       attention_unpacked_fwd_kernel<2, 4, true>,
       attention_unpacked_fwd_kernel<2, 4, true>}};
  return sm90_host::launch_attention<sm90::SoftmaxExp2>(
      kernels, attention_unpacked_wide_kernel, tq, tk, tv, args, batch,
      num_heads, static_cast<cudaStream_t>(stream), stream_kv, chunk_tiles);
}

}  // namespace

// q, k, v, o: [B, L, H, D] bf16, contiguous, 16-byte aligned; D a
// multiple of 8 up to 2,048, L up to 4,096. scale = D**-0.5 in f32. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a head dim or a length
// past the limits or a tensor map that cannot be encoded.
extern "C" int attention_unpacked_fwd(const void* q, const void* k,
                                      const void* v, void* o, int batch,
                                      int seq_len, int num_heads,
                                      int head_dim, float scale,
                                      void* stream) {
  return run(q, k, v, o, batch, seq_len, num_heads, head_dim, scale, false,
             sm90::kWideTiles, stream);
}

// attention_unpacked_fwd with K and V streamed at every length, also where
// they would stay resident (for tests and measurement: the same bits).
extern "C" int attention_unpacked_fwd_streamed(const void* q, const void* k,
                                               const void* v, void* o,
                                               int batch, int seq_len,
                                               int num_heads, int head_dim,
                                               float scale, void* stream) {
  return run(q, k, v, o, batch, seq_len, num_heads, head_dim, scale, true,
             sm90::kWideTiles, stream);
}

// attention_unpacked_fwd with `chunk_tiles` (1 to 4) of O's 64-column
// tiles a CTA past head dim 256, not 4 (for tests: every chunk count gives
// the same bits).
extern "C" int attention_unpacked_fwd_chunked(const void* q, const void* k,
                                              const void* v, void* o,
                                              int batch, int seq_len,
                                              int num_heads, int head_dim,
                                              float scale, int chunk_tiles,
                                              void* stream) {
  return run(q, k, v, o, batch, seq_len, num_heads, head_dim, scale, false,
             chunk_tiles, stream);
}
