// Fused multi-head attention forward on bf16 tensors: the q, k, v
// projections with bias, per-head max-shift softmax attention and the
// out-projection with bias, for Hopper (sm_90a), at any head dim D that is
// a multiple of 8 up to 2,048.
//
// Replaces: small_vision_tpu/ops/fused_block.py::_mha_kernel (reached via
// _mha_pallas / fused_mha). Per batch row, on x of width d and H heads of
// D (d = H*D in one process; a tensor rank's H heads of a wider model,
// d = 768 and H = 6 at UMD-B/4 over two ranks, whose out-projection then
// takes a zero bias and is summed over the ranks by the caller):
//   q, k, v = bf16(f32(x W) + b)              (three W (d, H*D), b (H*D))
//   per head: S = (q k^T) * scale, keys past L masked to -inf;
//             p = bf16(exp(S - rowmax) / rowsum), the division before the
//             rounding;  a = bf16(f32(p v))
//   o = bf16(f32(a Wo) + bo)                     (Wo (H*D, d), bo (d))
// the TPU kernel's rounding points; scale = f32(D**-0.5), as the TPU
// kernel rounds it.
//
// Bound on this card: at the sampler's shape (B=64, L=260, width 768, 12
// heads) the four projections and the two attention products are 91.8
// GFLOP, 0.093 ms at 989 TFLOP/s, against 55.8 MB of x, o and weights
// (0.017 ms at 3.35 TB/s): the floor is the tensor cores.
//
// Design. The TPU kernel keeps a batch row's q, k, v in VMEM; here they
// make one round trip through device memory as bf16, which the TPU kernel
// rounds them to as well: 2 x 76.7 MB at the sampler's shape, 0.046 ms,
// still below the operations. Three launches of two kernels, no atomics
// and no split-K, so two calls give the same bits:
//  (a) fused_mha_proj_kernel, C = bf16(f32(A W) + bias): the persistent
//      wgmma GEMM of sm90_gemm.cuh (`gemm_bias_tiles`, its design there)
//      with 128 x 128 tiles and a 5-stage ring. Launched for q, k, v at
//      once (one tensor map per weight and per output, chosen by the
//      tile's column block; the outputs are the three column blocks of one
//      (B, L, 3 H*D) scratch) and for the out-projection of the head
//      outputs. Its N (H*D) and K (d) are multiples of 8, the GEMM's rule
//      (ViT-mu: 2 heads of 16, H*D = 32, half of one 64-column box); the
//      wrapper (ops/fused_block.py) zero-pads a width that is not, and a
//      head dim that is not, whose heads it lays out at the next multiple
//      of 8 with zero columns (zero rows of Wo), run at that head dim with
//      the true head dim's scale.
//  (b) fused_mha_attn_kernel, per (head, batch row): the max-shift
//      attention core of sm90_attention.cuh (its design there, its head
//      dims one to four 64-column tiles, or past 256 its wide path, O's
//      columns split across CTAs) under its production softmax, exp2
//      of the log2(e)-scaled scores, reading the heads' q, k, v from the
//      scratch as heads 0..H-1, H..2H-1 and 2H..3H-1 of a (D, 3H, L, B)
//      tensor map and writing (B, L, H*D). K7 and K9 run the same core.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_attention.cuh"

namespace {

// ---- (a) the projection GEMM ---------------------------------------------

using ProjTiles = sm90::GemmTiles<>;

// C_w = bf16(f32(A W_w) + b_w) for w < num_w: A (m, k), W_w (k, n) and
// C_w (m, n) through their maps; k and n are multiples of 8.
__global__ void __launch_bounds__(sm90::kGemmThreads, 1)
fused_mha_proj_kernel(const __grid_constant__ CUtensorMap tm_a,
                      const __grid_constant__ CUtensorMap tm_w0,
                      const __grid_constant__ CUtensorMap tm_w1,
                      const __grid_constant__ CUtensorMap tm_w2,
                      const __grid_constant__ CUtensorMap tm_c0,
                      const __grid_constant__ CUtensorMap tm_c1,
                      const __grid_constant__ CUtensorMap tm_c2,
                      const __nv_bfloat16* __restrict__ b0,
                      const __nv_bfloat16* __restrict__ b1,
                      const __nv_bfloat16* __restrict__ b2, int m, int n,
                      int k, int num_w) {
  extern __shared__ uint8_t smem_raw[];
  sm90::gemm_bias_tiles<sm90::BiasOnly, ProjTiles>(
      smem_raw, &tm_a, &tm_w0, &tm_w1, &tm_w2, &tm_c0, &tm_c1, &tm_c2, b0, b1,
      b2, m, n, k, num_w);
}

// ---- (b) the attention core: sm90_attention.cuh's production softmax ---

template <int kGroups, int NT, bool kStream>
__global__ void __launch_bounds__(128 * kGroups, (NT == 1 ? 4 : 2) / kGroups)
fused_mha_attn_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const sm90::AttnArgs a) {
  extern __shared__ uint8_t smem_raw[];
  sm90::attention_heads<sm90::SoftmaxExp2, kGroups, NT, kStream>(
      smem_raw, &tm_q, &tm_k, &tm_v, a);
}

// Head dims past 256 (sm90::attention_wide).
__global__ void __launch_bounds__(128, 2)
fused_mha_attn_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const sm90::AttnArgs a, int chunk_tiles) {
  extern __shared__ uint8_t smem_raw[];
  sm90::attention_wide<sm90::SoftmaxExp2>(smem_raw, &tm_q, &tm_k, &tm_v, a,
                                          chunk_tiles);
}

}  // namespace

// Largest head dim the attention takes; any multiple of 8 up to it.
extern "C" int fused_mha_max_head_dim() { return sm90::kAttnMaxHeadDim; }

// Largest sequence length the attention takes at a head dim: 4,096 at
// every one (K and V stream past the resident limit).
extern "C" int fused_mha_max_len(int head_dim) {
  return sm90::attn_max_len(head_dim);
}

// (a): c (m, num_w * n) = [bf16(f32(a w_i) + b_i) for i < num_w] side by
// side; a (m, k), each w_i (k, n), b_i (n,); bf16, contiguous, 16-byte
// aligned; n and k multiples of 8, num_w 1 to 3 (unused w_i, b_i are
// ignored). Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// shape it does not take or a tensor map the driver refuses.
extern "C" int fused_mha_proj(const void* a, const void* w0, const void* w1,
                              const void* w2, const void* b0, const void* b1,
                              const void* b2, void* c, int m, int n, int k,
                              int num_w, void* stream) {
  if (m <= 0 || n <= 0 || n % 8 != 0 || k <= 0 || k % 8 != 0 ||
      num_w < 1 || num_w > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* ws[3] = {w0, w1, w2};
  CUtensorMap ta, tw[3], tc[3];
  if (!sm90_host::matrix_map(&ta, a, m, k, k, ProjTiles::kBM)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < 3; ++i) {
    const int src = i < num_w ? i : 0;
    // Column block src of c: 16-byte aligned, as n is a multiple of 8.
    __nv_bfloat16* ci = static_cast<__nv_bfloat16*>(c) +
                        static_cast<size_t>(src) * n;
    if (!sm90_host::matrix_map(&tw[i], ws[src], k, n, n, ProjTiles::kBK) ||
        !sm90_host::matrix_map(&tc[i], ci, m, n, num_w * n, 64)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaError_t err = cudaFuncSetAttribute(
      fused_mha_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(ProjTiles::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (m + ProjTiles::kBM - 1) / ProjTiles::kBM * num_w *
                    ((n + ProjTiles::kBN - 1) / ProjTiles::kBN);
  const int sms = sm90_host::sm_count();
  const int grid = tiles < sms ? tiles : sms;
  auto bf = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
  fused_mha_proj_kernel<<<grid, sm90::kGemmThreads, ProjTiles::kSmem,
                          static_cast<cudaStream_t>(stream)>>>(
      ta, tw[0], tw[1], tw[2], tc[0], tc[1], tc[2], bf(b0),
      bf(num_w > 1 ? b1 : b0), bf(num_w > 2 ? b2 : b0), m, n, k, num_w);
  return static_cast<int>(cudaGetLastError());
}

// (b): qkv (B, L, 3 H*D) bf16, q, k, v side by side; heads (B, L, H*D)
// bf16 out; D a multiple of 8 up to 2,048, L up to 4,096; scale = D**-0.5
// in f32. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a head dim or a length
// past the limits or a tensor map that cannot be encoded.
extern "C" int fused_mha_attention(const void* qkv, void* heads, int batch,
                                   int seq_len, int num_heads, int head_dim,
                                   float scale, void* stream) {
  if (!sm90_host::valid_head_dim(head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tm;
  if (!sm90_host::packed_head_map_d(&tm, qkv, batch, seq_len, 3 * num_heads,
                                    head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const sm90::AttnArgs args{0, num_heads, 2 * num_heads,
                            static_cast<__nv_bfloat16*>(heads),
                            num_heads * head_dim, seq_len, head_dim, scale};
  using Kernel = decltype(&fused_mha_attn_kernel<1, 1, false>);
  const Kernel kernels[4][3] = {
      {fused_mha_attn_kernel<1, 1, false>,
       fused_mha_attn_kernel<2, 1, false>,
       fused_mha_attn_kernel<2, 1, true>},
      {fused_mha_attn_kernel<1, 2, false>,
       fused_mha_attn_kernel<2, 2, false>,
       fused_mha_attn_kernel<2, 2, true>},
      {fused_mha_attn_kernel<2, 3, true>,
       fused_mha_attn_kernel<2, 3, true>,
       fused_mha_attn_kernel<2, 3, true>},
      {fused_mha_attn_kernel<2, 4, true>,
       fused_mha_attn_kernel<2, 4, true>,
       fused_mha_attn_kernel<2, 4, true>}};
  return sm90_host::launch_attention<sm90::SoftmaxExp2>(
      kernels, fused_mha_attn_wide_kernel, tm, tm, tm, args, batch,
      num_heads, static_cast<cudaStream_t>(stream));
}

// x, o: (B, L, width) bf16; heads (scratch): (B, L, H*D) bf16; qkv
// (scratch): (B, L, 3 H*D) bf16; wq, wk, wv: (width, H*D) and wo
// (H*D, width) bf16 row-major (in, out); bq, bk, bv: (H*D,) and bo
// (width,) bf16; all contiguous and 16-byte aligned; width and H*D
// multiples of 8, D a multiple of 8 up to 2,048, L up to 4,096. scale =
// D**-0.5 in f32 (the caller's: of the true head dim where it ran the
// heads zero-padded to D).
// The three launches: (a) q, k, v; (b) the heads; (a) the out-projection.
// Returns the first non-zero status.
extern "C" int fused_mha_fwd(const void* x, const void* wq, const void* bq,
                             const void* wk, const void* bk, const void* wv,
                             const void* bv, const void* wo, const void* bo,
                             void* qkv, void* heads, void* o, int batch,
                             int seq_len, int width, int num_heads,
                             int head_dim, float scale, void* stream) {
  if (!sm90_host::valid_head_dim(head_dim) ||
      seq_len > sm90::attn_max_len(head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hd = num_heads * head_dim;
  const int m = batch * seq_len;
  int status = fused_mha_proj(x, wq, wk, wv, bq, bk, bv, qkv, m, hd, width,
                              3, stream);
  if (status != 0) return status;
  status = fused_mha_attention(qkv, heads, batch, seq_len, num_heads,
                               head_dim, scale, stream);
  if (status != 0) return status;
  return fused_mha_proj(heads, wo, wo, wo, bo, bo, bo, o, m, width, hd, 1,
                        stream);
}
