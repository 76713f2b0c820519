// Fused multi-head attention forward on bf16 tensors: the q, k, v
// projections with bias, per-head max-shift softmax attention and the
// out-projection with bias, for Hopper (sm_90a).
//
// Replaces: small_vision_tpu/ops/fused_block.py::_mha_kernel (reached via
// _mha_pallas / fused_mha). Per batch row:
//   q, k, v = bf16(f32(x W) + b)                             (three W, b)
//   per head: S = (q k^T) * scale, keys past L masked to -inf;
//             p = bf16(exp(S - rowmax) / rowsum), the division before the
//             rounding;  a = bf16(f32(p v))
//   o = bf16(f32(a Wo) + bo)
// the TPU kernel's rounding points.
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
//      (B, L, 3 H*64) scratch) and for the out-projection of the head
//      outputs.
//  (b) fused_mha_attn_kernel, per (head, batch row): K3's structure
//      (attention_packed.cu) with the exact max-shift softmax. The head's K
//      and V blocks come by TMA through 3-D tensor maps of the scratch,
//      bounded at L (rows past it arrive as zeros) and stay resident; each
//      warpgroup walks its query tiles, each from its own Q buffer. Pass 1
//      over the key blocks keeps a running max and a rescaled sum in base
//      2, computing block j + 1's S while it reads block j's; pass 2
//      recomputes S (the same products, the same bits), forms p with the
//      final max and sum, rounds it and feeds it from registers to the
//      P V product, issued with the next block's S. Column offsets of q,
//      k, v and the output's row stride are arguments, so the kernel
//      serves any packed layout. Q stays in shared memory (wgmma's A from
//      registers would cost 16 registers a thread, and at 128 a thread
//      ptxas spilled and serialised the products).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kTile = sm90::kTileRows;
constexpr int kTileBytes = sm90::kTileBytes;
constexpr int kSmemLimit = 232448;
using sm90::wg_barrier;

// ---- (a) the projection GEMM ---------------------------------------------

using ProjTiles = sm90::GemmTiles<>;

// C_w = bf16(f32(A W_w) + b_w) for w < num_w: A (m, k), W_w (k, n) and
// C_w (m, n) through their maps; k and n are multiples of 64.
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

// ---- (b) the attention core ----------------------------------------------

// Warpgroups a CTA: two, or one for heads of at most kShortTiles tiles
// (as K3).
constexpr int kShortTiles = 3;

// 1 KB to align the tiles; nkb K and nkb V blocks; one Q tile a warpgroup;
// barriers: one a K block, one a V block, one a Q tile.
__host__ __device__ constexpr size_t attn_smem_bytes(int nkb, int groups) {
  return 1024 + static_cast<size_t>(2 * nkb + groups) * kTileBytes +
         8 * static_cast<size_t>(2 * nkb + groups);
}

// Three maps over (cols, L, B) row layouts (rows_map); head h's q, k, v
// are the 64 columns at q_col + 64 h, k_col + 64 h, v_col + 64 h of their
// maps, and its output the 64 columns at 64 h of o, o_ld elements a row.
template <int kGroups>
__global__ void __launch_bounds__(128 * kGroups, 4 / kGroups)
fused_mha_attn_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, int q_col,
                      int k_col, int v_col, __nv_bfloat16* __restrict__ o,
                      int o_ld, int seq_len, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align_tiles(smem_raw);
  const int nkb = (seq_len + kTile - 1) / kTile;
  const int nqt = nkb;
  uint8_t* k_s = smem;  // block j at j * 8 KB
  uint8_t* v_s = k_s + nkb * kTileBytes;
  uint8_t* q_s = v_s + nkb * kTileBytes;  // warpgroup w's at w * 8 KB
  uint64_t* k_full = reinterpret_cast<uint64_t*>(q_s + kGroups * kTileBytes);
  uint64_t* v_full = k_full + nkb;
  uint64_t* q_full = v_full + nkb;

  const int head = blockIdx.x;
  const int batch = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int hcol = head * kHeadDim;

  if (tid == 0) {
    for (int j = 0; j < 2 * nkb + kGroups; ++j) sm90::mbar_init(&k_full[j], 1);
    sm90::fence_barrier_init();
    // The first Q tiles, the K blocks (pass 1 needs them first), then V.
    for (int w = 0; w < kGroups && w < nqt; ++w) {
      sm90::mbar_arrive_expect_tx(&q_full[w], kTileBytes);
      sm90::tma_load_3d(q_s + w * kTileBytes, &tm_q, &q_full[w], q_col + hcol,
                        w * kTile, batch);
    }
    for (int j = 0; j < nkb; ++j) {
      sm90::mbar_arrive_expect_tx(&k_full[j], kTileBytes);
      sm90::tma_load_3d(k_s + j * kTileBytes, &tm_k, &k_full[j], k_col + hcol,
                        j * kTile, batch);
    }
    for (int j = 0; j < nkb; ++j) {
      sm90::mbar_arrive_expect_tx(&v_full[j], kTileBytes);
      sm90::tma_load_3d(v_s + j * kTileBytes, &tm_v, &v_full[j], v_col + hcol,
                        j * kTile, batch);
    }
  }
  __syncthreads();

  const int wg = warp / 4;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  __nv_bfloat16* out =
      o + static_cast<size_t>(batch) * seq_len * o_ld + hcol;
  uint8_t* my_q = q_s + wg * kTileBytes;
  const uint64_t d_q = sm90::desc_k_major(my_q);
  auto issue_s = [&](float (&s)[32], int j) {
    sm90::mbar_wait(&k_full[j], 0);
    sm90::wgmma_fence();
    sm90::gemm_nt(s, d_q, sm90::desc_k_major(k_s + j * kTileBytes));
    sm90::wgmma_commit();
  };

  for (int t = wg, use = 0; t < nqt; t += kGroups, ++use) {
    sm90::mbar_wait(&q_full[wg], use & 1);

    // Pass 1: this lane's running max and rescaled sum of rows g and
    // g + 8 over its 16 keys of each block, in base 2 (S pre-scaled by
    // scale * log2(e)). Block j + 1's S is computed while block j's is
    // read.
    float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F, l_lo = 0.f, l_hi = 0.f;
    auto update = [&](float (&s)[32], int j) {
      float b_lo = -CUDART_INF_F, b_hi = -CUDART_INF_F;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = j * kTile + nt * 8 + 2 * t4 + (i & 1);
          const float x = key < seq_len ? s[4 * nt + i] * scale_log2
                                        : -CUDART_INF_F;
          s[4 * nt + i] = x;
          if (i < 2) {
            b_lo = fmaxf(b_lo, x);
          } else {
            b_hi = fmaxf(b_hi, x);
          }
        }
      }
      const float n_lo = fmaxf(m_lo, b_lo);
      const float n_hi = fmaxf(m_hi, b_hi);
      if (n_lo > -CUDART_INF_F) {  // else every key so far is masked
        float e = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          e += sm90::exp2_ftz(s[4 * nt] - n_lo) +
               sm90::exp2_ftz(s[4 * nt + 1] - n_lo);
        }
        l_lo = l_lo * sm90::exp2_ftz(m_lo - n_lo) + e;
        m_lo = n_lo;
      }
      if (n_hi > -CUDART_INF_F) {
        float e = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          e += sm90::exp2_ftz(s[4 * nt + 2] - n_hi) +
               sm90::exp2_ftz(s[4 * nt + 3] - n_hi);
        }
        l_hi = l_hi * sm90::exp2_ftz(m_hi - n_hi) + e;
        m_hi = n_hi;
      }
    };
    {
      float s0[32], s1[32];
      issue_s(s0, 0);
      for (int j = 0; j < nkb; j += 2) {
        if (j + 1 < nkb) {
          issue_s(s1, j + 1);
          sm90::wgmma_wait<1>();
        } else {
          sm90::wgmma_wait<0>();
        }
        sm90::fence(s0);
        update(s0, j);
        if (j + 1 < nkb) {
          if (j + 2 < nkb) {
            issue_s(s0, j + 2);
            sm90::wgmma_wait<1>();
          } else {
            sm90::wgmma_wait<0>();
          }
          sm90::fence(s1);
          update(s1, j + 1);
        }
      }
    }
    // Merge the four lanes of a row (a lane that saw no key has l = 0).
    const float row_m_lo = sm90::quad_max(m_lo);
    const float row_m_hi = sm90::quad_max(m_hi);
    const float inv_lo =
        1.f / sm90::quad_sum(l_lo * sm90::exp2_ftz(m_lo - row_m_lo));
    const float inv_hi =
        1.f / sm90::quad_sum(l_hi * sm90::exp2_ftz(m_hi - row_m_hi));

    // Pass 2: S again, p rounded, O += p V; block j + 1's S is issued with
    // block j's P V product.
    float sacc[32], oacc[32];
    uint32_t pa[16];
    issue_s(sacc, 0);
    sm90::wgmma_wait<0>();
    sm90::fence(sacc);
    for (int j = 0; j < nkb; ++j) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = j * kTile + nt * 8 + 2 * t4 + (i & 1);
          const float rm = i < 2 ? row_m_lo : row_m_hi;
          const float inv = i < 2 ? inv_lo : inv_hi;
          sacc[4 * nt + i] =
              key < seq_len
                  ? sm90::exp2_ftz(sacc[4 * nt + i] * scale_log2 - rm) * inv
                  : 0.f;
        }
      }
      sm90::pack_a(pa, sacc);
      sm90::mbar_wait(&v_full[j], 0);
      sm90::wgmma_fence();
      sm90::gemm_rn(oacc, pa, sm90::desc_mn_major(v_s + j * kTileBytes),
                    j > 0);
      if (j + 1 < nkb) {
        sm90::mbar_wait(&k_full[j + 1], 0);
        sm90::gemm_nt(sacc, d_q,
                      sm90::desc_k_major(k_s + (j + 1) * kTileBytes));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence(oacc);
      sm90::fence(sacc);
    }

    // The tile's products are done: its Q buffer takes the warpgroup's
    // next tile while this one is stored.
    if (t + kGroups < nqt) {
      wg_barrier(wg);
      if (tid % 128 == 0) {
        sm90::mbar_arrive_expect_tx(&q_full[wg], kTileBytes);
        sm90::tma_load_3d(my_q, &tm_q, &q_full[wg], q_col + hcol,
                          (t + kGroups) * kTile, batch);
      }
    }
    sm90::store_acc(out, o_ld, t * kTile + (warp % 4) * 16 + g, seq_len,
                    oacc, 1.f, 1.f, t4);
  }
}

}  // namespace

// Largest sequence length the attention takes (a head's K and V stay
// resident in the 227 KB of shared memory a block can use).
extern "C" int fused_mha_max_len() {
  int nkb = 1;
  while (attn_smem_bytes(nkb + 1, 2) <= kSmemLimit) ++nkb;
  return nkb * kTile;
}

// (a): c (m, num_w * n) = [bf16(f32(a w_i) + b_i) for i < num_w] side by
// side; a (m, n), each w_i (n, n), b_i (n,); bf16, contiguous, 16-byte
// aligned; n a multiple of 64, num_w 1 to 3 (unused w_i, b_i are
// ignored). Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// shape it does not take or a tensor map the driver refuses.
extern "C" int fused_mha_proj(const void* a, const void* w0, const void* w1,
                              const void* w2, const void* b0, const void* b1,
                              const void* b2, void* c, int m, int n,
                              int num_w, void* stream) {
  if (m <= 0 || n <= 0 || n % 64 != 0 || num_w < 1 || num_w > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* ws[3] = {w0, w1, w2};
  CUtensorMap ta, tw[3], tc[3];
  if (!sm90_host::matrix_map(&ta, a, m, n, n, ProjTiles::kBM)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < 3; ++i) {
    const int src = i < num_w ? i : 0;
    __nv_bfloat16* ci = static_cast<__nv_bfloat16*>(c) +
                        static_cast<size_t>(src) * n;
    if (!sm90_host::matrix_map(&tw[i], ws[src], n, n, n, ProjTiles::kBK) ||
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
      bf(num_w > 1 ? b1 : b0), bf(num_w > 2 ? b2 : b0), m, n, n, num_w);
  return static_cast<int>(cudaGetLastError());
}

// (b): qkv (B, L, 3 H*64) bf16, q, k, v side by side; heads (B, L, H*64)
// bf16 out; scale = 64**-0.5 in f32. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a length past the limit or a tensor map the
// driver refuses.
extern "C" int fused_mha_attention(const void* qkv, void* heads, int batch,
                                   int seq_len, int num_heads, float scale,
                                   void* stream) {
  if (seq_len > fused_mha_max_len()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hd = num_heads * kHeadDim;
  CUtensorMap tm;
  if (!sm90_host::rows_map(&tm, qkv, batch, seq_len, 3 * hd, 3 * hd)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nkb = (seq_len + kTile - 1) / kTile;
  const int groups = nkb <= kShortTiles ? 1 : 2;
  const auto kernel =
      groups == 1 ? fused_mha_attn_kernel<1> : fused_mha_attn_kernel<2>;
  const size_t smem = attn_smem_bytes(nkb, groups);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(num_heads, batch), 128 * groups, smem,
           static_cast<cudaStream_t>(stream)>>>(
      tm, tm, tm, 0, hd, 2 * hd, static_cast<__nv_bfloat16*>(heads), hd,
      seq_len, scale * 1.44269504088896341f);
  return static_cast<int>(cudaGetLastError());
}

// x, heads (scratch), o: (B, L, H*64) bf16; qkv (scratch): (B, L, 3 H*64)
// bf16; wq, wk, wv, wo: (H*64, H*64) bf16 row-major (in, out); bq, bk, bv,
// bo: (H*64,) bf16; all contiguous and 16-byte aligned. scale = 64**-0.5
// in f32. The three launches: (a) q, k, v; (b) the heads; (a) the
// out-projection. Returns the first non-zero status.
extern "C" int fused_mha_fwd(const void* x, const void* wq, const void* bq,
                             const void* wk, const void* bk, const void* wv,
                             const void* bv, const void* wo, const void* bo,
                             void* qkv, void* heads, void* o, int batch,
                             int seq_len, int num_heads, float scale,
                             void* stream) {
  const int hd = num_heads * kHeadDim;
  const int m = batch * seq_len;
  int status = fused_mha_proj(x, wq, wk, wv, bq, bk, bv, qkv, m, hd, 3,
                              stream);
  if (status != 0) return status;
  status = fused_mha_attention(qkv, heads, batch, seq_len, num_heads, scale,
                               stream);
  if (status != 0) return status;
  return fused_mha_proj(heads, wo, wo, wo, bo, bo, bo, o, m, hd, 1, stream);
}
