// Fused multi-head attention forward on bf16 tensors: the q, k, v
// projections with bias, per-head max-shift softmax attention and the
// out-projection with bias, for Hopper (sm_90a).
//
// Replaces: small_vision_tpu/ops/fused_block.py::_mha_kernel (reached via
// _mha_pallas / fused_mha). Per batch row:
//   q, k, v = bf16(f32(x W) + b)                             (three W, b)
//   per head: S = (q k^T) * scale; p = bf16(softmax(S)) with the row max
//             subtracted and the division before the rounding;
//             a = bf16(f32(p v))
//   o = bf16(f32(a Wo) + bo)
// the TPU kernel's rounding points.
//
// Bound on this card: at the sampler's shape (B=64, L=260, width 768, 12
// heads) the four projections and the two attention products are 91.8
// GFLOP, 0.093 ms at 989 TFLOP/s, against 55.8 MB of x, o and weights
// (0.017 ms at 3.35 TB/s): the floor is the tensor cores.
//
// Design. The TPU kernel holds a batch row's q, k, v (1.25 MB at L = 272)
// and all weights in VMEM; a block here has 227 KB. Two kernels in one
// launch of the wrapper:
//  (1) fused_mha_heads: one block of 8 warps per (batch row, head). It
//      projects its (L, 64) parts of q, k and v, one after the other, by
//      streaming x[b, :, 64-column piece] and W[piece, head's 64 columns]
//      through shared memory (double-buffered with cp.async), adds the bias
//      in f32, rounds, and keeps the three parts in shared memory. Then
//      each warp runs the max-shift attention core of
//      attention_maxshift.cuh on 16 query rows at a time and writes the
//      rounded head output to its 64 columns of an (B, L, width) scratch.
//      q, k, v, the scores and the probabilities never reach device
//      memory.
//  (2) fused_mha_out_proj: the out-projection sums over heads, that is
//      over blocks of (1), so it is a second kernel: a tiled product of the
//      scratch with Wo (128 x 64 output tiles, 64-deep stages,
//      double-buffered), f32 sums in a fixed order, bias added in f32, one
//      rounding. No atomics, so two launches give the same bits.
// What leaves the chip between the two: the bf16 head outputs (B, L,
// width), written once and read once (25.6 MB each way at the sampler's
// shape). Each head's block reads the batch row's x three times (once per
// projection) from the L2. Products are bf16 mma.sync m16n8k16 with f32
// accumulation; weights are read row-major as they lie, B fragments
// through ldmatrix.trans. Not yet used: wgmma, TMA, a cluster that shares
// x between the heads of a batch row (a later change).

#include "attention_maxshift.cuh"

namespace {

using namespace tiles;

constexpr int kHeadDim = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxMT = 3;  // m-tiles of 16 rows a warp owns: L <= 8 * 16 * 3
constexpr int kKC = 64;    // depth of one projection stage

// (1): q, k, v [lp][72]; two stages of x piece [lp][72] and W piece
// [64][72].
__host__ __device__ constexpr size_t heads_smem_bytes(int lp) {
  return sizeof(__nv_bfloat16) * kRowStride *
         (3 * static_cast<size_t>(lp) + 2 * (static_cast<size_t>(lp) + kKC));
}

__global__ void __launch_bounds__(kThreads, 1)
fused_mha_heads(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ wq,
                const __nv_bfloat16* __restrict__ bq,
                const __nv_bfloat16* __restrict__ wk,
                const __nv_bfloat16* __restrict__ bk,
                const __nv_bfloat16* __restrict__ wv,
                const __nv_bfloat16* __restrict__ bv,
                __nv_bfloat16* __restrict__ attn, int seq_len, int num_heads,
                int lp, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qkv_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* buf = qkv_s + 3 * lp * kRowStride;
  const int stage_elems = (lp + kKC) * kRowStride;

  const int head = blockIdx.x;
  const int batch = blockIdx.y;
  const int hd = num_heads * kHeadDim;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const __nv_bfloat16* x_b = x + static_cast<size_t>(batch) * seq_len * hd;
  const int n_chunks = hd / kKC;
  const int n_stages = 3 * n_chunks;

  auto load_stage = [&](int s) {
    __nv_bfloat16* xs = buf + (s & 1) * stage_elems;
    __nv_bfloat16* ws = xs + lp * kRowStride;
    const int proj = s / n_chunks;
    const int kc = s - proj * n_chunks;
    const __nv_bfloat16* w = proj == 0 ? wq : (proj == 1 ? wk : wv);
    // Rows past L are zero-filled, so their q, k, v are the bias: finite.
    cp_async_tile(xs, kRowStride, x_b + kc * kKC, hd, lp, kKC, seq_len, tid,
                  kThreads);
    cp_async_tile(ws, kRowStride,
                  w + static_cast<size_t>(kc) * kKC * hd + head * kHeadDim, hd,
                  kKC, kHeadDim, kKC, tid, kThreads);
    cp_async_commit();
  };

  load_stage(0);
  float acc[kMaxMT][8][4];
#pragma unroll
  for (int mi = 0; mi < kMaxMT; ++mi) zero_acc(acc[mi]);

  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) {
      load_stage(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* xs = buf + (s & 1) * stage_elems;
    const __nv_bfloat16* ws = xs + lp * kRowStride;
    const int proj = s / n_chunks;
    const int kc = s - proj * n_chunks;
#pragma unroll
    for (int mi = 0; mi < kMaxMT; ++mi) {
      const int r0 = (warp + mi * kWarps) * 16;
      if (r0 < lp) {
#pragma unroll
        for (int ks = 0; ks < kKC / 16; ++ks) {
          uint32_t a[4];
          load_a(a, xs, kRowStride, r0, ks * 16, lane);
          acc_rows(acc[mi], a, ws, ks * 16, lane);
        }
      }
    }
    if (kc == n_chunks - 1) {
      // Bias in f32, one rounding, into this projection's shared part.
      const __nv_bfloat16* bias =
          (proj == 0 ? bq : (proj == 1 ? bk : bv)) + head * kHeadDim;
      __nv_bfloat16* dst = qkv_s + proj * lp * kRowStride;
#pragma unroll
      for (int mi = 0; mi < kMaxMT; ++mi) {
        const int r0 = (warp + mi * kWarps) * 16;
        if (r0 < lp) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int col = nt * 8 + t4 * 2;
            const float b0 = __bfloat162float(bias[col]);
            const float b1 = __bfloat162float(bias[col + 1]);
            __nv_bfloat16* lo = dst + (r0 + g) * kRowStride + col;
            *reinterpret_cast<uint32_t*>(lo) =
                pack_bf16(acc[mi][nt][0] + b0, acc[mi][nt][1] + b1);
            *reinterpret_cast<uint32_t*>(lo + 8 * kRowStride) =
                pack_bf16(acc[mi][nt][2] + b0, acc[mi][nt][3] + b1);
          }
          zero_acc(acc[mi]);
        }
      }
    }
    __syncthreads();  // the stage's buffer may be written again
  }

  // Attention on the three shared parts; a warp takes 16 query rows at a
  // time and writes its head's 64 columns of the scratch.
  const __nv_bfloat16* q_s = qkv_s;
  const __nv_bfloat16* k_s = qkv_s + lp * kRowStride;
  const __nv_bfloat16* v_s = k_s + lp * kRowStride;
  __nv_bfloat16* out = attn + static_cast<size_t>(batch) * seq_len * hd +
                       head * kHeadDim;
  for (int r0 = warp * 16; r0 < seq_len; r0 += kWarps * 16) {
    float o[8][4];
    attn_maxshift_rows(o, q_s, r0, k_s, v_s, lp, seq_len, scale, lane);
    store_rows(out, hd, r0 + g, seq_len, o, 1.f, 1.f, lane);
  }
}

// (2) C = bf16(f32(A W) + bias): A (m, k), W (k, n), C (m, n) bf16
// row-major, k and n multiples of 64. 128 x 64 tiles; warp (w % 4, w / 4)
// owns rows 32 (w % 4) and columns 32 (w / 4) of the tile.
constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kGemmStage = (kBM + kKC) * kRowStride;

__global__ void __launch_bounds__(kThreads)
fused_mha_out_proj(const __nv_bfloat16* __restrict__ a,
          const __nv_bfloat16* __restrict__ w,
          const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ c,
          int m, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* buf = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int wr = (warp & 3) * 32;
  const int wc = (warp >> 2) * 32;
  const int n_stages = k / kKC;

  auto load_stage = [&](int s) {
    __nv_bfloat16* as = buf + (s & 1) * kGemmStage;
    __nv_bfloat16* ws = as + kBM * kRowStride;
    cp_async_tile(as, kRowStride, a + static_cast<size_t>(row0) * k + s * kKC,
                  k, kBM, kKC, m - row0, tid, kThreads);
    cp_async_tile(ws, kRowStride,
                  w + static_cast<size_t>(s) * kKC * n + col0, n, kKC, kBN,
                  kKC, tid, kThreads);
    cp_async_commit();
  };

  load_stage(0);
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) {
      load_stage(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* as = buf + (s & 1) * kGemmStage;
    const __nv_bfloat16* ws = as + kBM * kRowStride;
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      uint32_t b[2][4];
      load_b_pair_trans(b[0], ws, kRowStride, ks * 16, wc, lane);
      load_b_pair_trans(b[1], ws, kRowStride, ks * 16, wc + 16, lane);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        uint32_t af[4];
        load_a(af, as, kRowStride, wr + mi * 16, ks * 16, lane);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          mma_bf16_16816(acc[mi][np * 2], af, b[np][0], b[np][1]);
          mma_bf16_16816(acc[mi][np * 2 + 1], af, b[np][2], b[np][3]);
        }
      }
    }
    __syncthreads();  // the stage's buffer may be written again
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int row_lo = row0 + wr + mi * 16 + g;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = col0 + wc + nt * 8 + t4 * 2;
      const float b0 = __bfloat162float(bias[col]);
      const float b1 = __bfloat162float(bias[col + 1]);
      if (row_lo < m) {
        *reinterpret_cast<uint32_t*>(c + static_cast<size_t>(row_lo) * n +
                                     col) =
            pack_bf16(acc[mi][nt][0] + b0, acc[mi][nt][1] + b1);
      }
      if (row_lo + 8 < m) {
        *reinterpret_cast<uint32_t*>(c + static_cast<size_t>(row_lo + 8) * n +
                                     col) =
            pack_bf16(acc[mi][nt][2] + b0, acc[mi][nt][3] + b1);
      }
    }
  }
}

}  // namespace

// Largest sequence length the kernels take: a head's q, k, v and the two
// projection stages must fit in the 227 KB of shared memory a block can
// use, and a warp owns at most kMaxMT tiles of 16 rows.
extern "C" int fused_mha_max_len() {
  int lp = 16;
  while (heads_smem_bytes(lp + 16) <= 232448 &&
         lp + 16 <= kWarps * 16 * kMaxMT) {
    lp += 16;
  }
  return lp;
}

// x, attn (scratch), o: (B, L, H*64) bf16; wq, wk, wv, wo: (H*64, H*64)
// bf16 row-major (in, out); bq, bk, bv, bo: (H*64,) bf16; all contiguous
// and 16-byte aligned. scale = 64**-0.5 in f32. Returns cudaGetLastError().
extern "C" int fused_mha_fwd(const void* x, const void* wq, const void* bq,
                             const void* wk, const void* bk, const void* wv,
                             const void* bv, const void* wo, const void* bo,
                             void* attn, void* o, int batch, int seq_len,
                             int num_heads, float scale, void* stream) {
  const int lp = (seq_len + 15) / 16 * 16;
  if (lp > fused_mha_max_len()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = heads_smem_bytes(lp);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mha_heads, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto bf = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
  fused_mha_heads<<<dim3(num_heads, batch), kThreads, smem, s>>>(
      bf(x), bf(wq), bf(bq), bf(wk), bf(bk), bf(wv), bf(bv),
      static_cast<__nv_bfloat16*>(attn), seq_len, num_heads, lp, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // Two stages of the product: 54 KB, above the 48 KB default.
  const size_t gemm_smem = sizeof(__nv_bfloat16) * 2 * kGemmStage;
  err = cudaFuncSetAttribute(fused_mha_out_proj,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(gemm_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hd = num_heads * kHeadDim;
  const int m = batch * seq_len;
  fused_mha_out_proj<<<dim3(hd / kBN, (m + kBM - 1) / kBM), kThreads,
                       gemm_smem, s>>>(
      bf(attn), bf(wo), bf(bo), static_cast<__nv_bfloat16*>(o), m, hd, hd);
  return static_cast<int>(cudaGetLastError());
}
