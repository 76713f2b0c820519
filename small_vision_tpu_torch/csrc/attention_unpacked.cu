// Bidirectional attention on [B, L, H, 64] bf16 tensors with the max-shift
// softmax, forward, for Hopper (sm_90a).
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
// Design: a contiguous [B, L, H, 64] tensor is the packed (B, L, H*64)
// one, so the kernel reads heads in place; the TPU wrapper's transposes
// and pads have no counterpart. One block takes 64 query rows of one
// (batch, head) and stages that head's K and V row-major in shared memory
// (83 KB with the query tile at L = 272, above the 48 KB default, so the
// entry point raises the limit). Four warps own 16 query rows each and run
// the shared two-pass core of attention_maxshift.cuh.

#include "attention_maxshift.cuh"

namespace {

using namespace tiles;

constexpr int kHeadDim = 64;
constexpr int kQTile = 64;
constexpr int kThreads = 128;

__host__ __device__ constexpr size_t smem_bytes(int lk_pad) {
  return sizeof(__nv_bfloat16) * kRowStride *
         (2 * static_cast<size_t>(lk_pad) + kQTile);
}

__global__ void __launch_bounds__(kThreads)
attention_unpacked_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              __nv_bfloat16* __restrict__ o, int seq_len,
                              int num_heads, int lk_pad, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + lk_pad * kRowStride;
  __nv_bfloat16* q_s = v_s + lk_pad * kRowStride;

  const int q0 = blockIdx.x * kQTile;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const size_t ld = static_cast<size_t>(num_heads) * kHeadDim;
  const size_t base = static_cast<size_t>(batch) * seq_len * ld +
                      static_cast<size_t>(head) * kHeadDim;
  const int tid = threadIdx.x;

  // Rows past L are zero-filled: finite scores that the key mask drops.
  cp_async_tile(k_s, kRowStride, k + base, ld, lk_pad, kHeadDim, seq_len, tid,
                kThreads);
  cp_async_tile(v_s, kRowStride, v + base, ld, lk_pad, kHeadDim, seq_len, tid,
                kThreads);
  cp_async_tile(q_s, kRowStride, q + base + q0 * ld, ld, kQTile, kHeadDim,
                seq_len - q0, tid, kThreads);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = warp * 16;
  if (q0 + r0 >= seq_len) return;  // whole warp past L (no barrier follows)

  float acc[8][4];
  attn_maxshift_rows(acc, q_s, r0, k_s, v_s, lk_pad, seq_len, scale, lane);
  store_rows(o + base, ld, q0 + r0 + (lane >> 2), seq_len, acc, 1.f, 1.f,
             lane);
}

}  // namespace

// Largest sequence length the kernel takes (a head's K and V must fit in
// the 227 KB of shared memory a block can use).
extern "C" int attention_unpacked_max_len() {
  int lk = 16;
  while (smem_bytes(lk + 16) <= 232448) lk += 16;
  return lk;
}

// q, k, v, o: [B, L, H, 64] bf16, contiguous, 16-byte aligned.
// scale = 64**-0.5 in f32. Returns cudaGetLastError().
extern "C" int attention_unpacked_fwd(const void* q, const void* k,
                                      const void* v, void* o, int batch,
                                      int seq_len, int num_heads, float scale,
                                      void* stream) {
  const int lk_pad = (seq_len + 15) / 16 * 16;
  if (lk_pad > attention_unpacked_max_len()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(lk_pad);
  cudaError_t err = cudaFuncSetAttribute(
      attention_unpacked_fwd_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq_len + kQTile - 1) / kQTile, num_heads, batch);
  attention_unpacked_fwd_kernel<<<grid, kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      seq_len, num_heads, lk_pad, scale);
  return static_cast<int>(cudaGetLastError());
}
