// Bidirectional attention on [B, L, H, 64] bf16 tensors with the max-shift
// softmax, backward, for Hopper (sm_90a).
//
// Replaces: small_vision_tpu/ops/attention.py::_attn_bwd_kernel (reached
// via _pallas_attention_bwd_impl, the custom VJP of fused_attention). Per
// (batch, head), recomputing the forward's probabilities:
//   S  = (Q K^T) * scale, keys past L masked;  P = softmax(S)      (f32)
//   dV = bf16(P)^T dO
//   dP = dO V^T                                                     (f32)
//   dS = bf16(P * (dP - rowsum(dP * P)))
//   dQ = (dS K) * scale;   dK = (dS^T Q) * scale
// with f32 sums and bf16 outputs: the TPU kernel's formulas and rounding
// points (P stays f32 inside dS, is rounded for dV; scale is applied to the
// f32 products, where the packed backward folds it into an operand).
//
// Bound on this card: at B=128, H=12, L=257 the 7*B*L*H*64*2 bytes of q, k,
// v, dO, dq, dk and dv (354 MB, 0.106 ms at 3.35 TB/s) outweigh the five
// products of 2*B*H*L^2*64 flops (65 GFLOP, 0.066 ms at 989 TFLOP/s).
//
// Design: the packed backward's split (attention_packed_bwd.cu), so that
// every output element is summed by one thread in a fixed order: no
// atomics, and two launches give the same bits.
//  (a) attn_unpacked_bwd_dq: one block per (b, h, 64-query tile), four warps
//      of 16 rows. It stages the head's K and V and makes two passes over
//      the keys: the first keeps, per lane, a running max, a sum of exp and
//      a sum of dP * exp, both rescaled when the max grows, and merges the
//      four lanes of a row into m, r = 1 / rowsum and c = rowsum(dP * P),
//      stored to (B, H, L) f32 buffers; the second forms dS and
//      accumulates dS K.
//  (b) attn_unpacked_bwd_dkdv: one block per (b, h, 64-key tile). It stages
//      the head's Q and dO and m, r, c from (a); for each block of 16
//      queries it recomputes P^T and dP^T, forms dS^T, and accumulates dV
//      and dK in f32 registers.
// Every product is a bf16 mma.sync with f32 accumulation. All operands are
// staged row-major; the products that contract over rows read their B
// fragments through ldmatrix.trans, so nothing is stored transposed.

#include <math_constants.h>

#include "attention_maxshift.cuh"

namespace {

using namespace tiles;

constexpr int kHeadDim = 64;
constexpr int kTile = 64;  // query rows (a) or key rows (b) per block
constexpr int kThreads = 128;

// (a): K, V [lp][72]; Q, dO tiles [64][72].
__host__ __device__ constexpr size_t dq_smem_bytes(int lp) {
  return sizeof(__nv_bfloat16) * kRowStride *
         (2 * static_cast<size_t>(lp) + 2 * kTile);
}

// (b): Q, dO [lp][72]; K, V tiles [64][72]; then m, r, c, [lp] f32 each.
__host__ __device__ constexpr size_t dkv_smem_bytes(int lp) {
  return dq_smem_bytes(lp) + sizeof(float) * 3 * static_cast<size_t>(lp);
}

__device__ __forceinline__ void load_a4(uint32_t (&a)[4][4],
                                        const __nv_bfloat16* tile, int r0,
                                        int lane) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    load_a(a[ks], tile, kRowStride, r0, ks * 16, lane);
  }
}

__global__ void __launch_bounds__(kThreads)
attn_unpacked_bwd_dq(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     __nv_bfloat16* __restrict__ dq, float* __restrict__ m_out,
                     float* __restrict__ r_out, float* __restrict__ c_out,
                     int seq_len, int num_heads, int lp, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + lp * kRowStride;
  __nv_bfloat16* q_s = v_s + lp * kRowStride;
  __nv_bfloat16* do_s = q_s + kTile * kRowStride;

  const int q0 = blockIdx.x * kTile;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const size_t ld = static_cast<size_t>(num_heads) * kHeadDim;
  const size_t base = static_cast<size_t>(batch) * seq_len * ld +
                      static_cast<size_t>(head) * kHeadDim;
  const int tid = threadIdx.x;

  cp_async_tile(k_s, kRowStride, k + base, ld, lp, kHeadDim, seq_len, tid,
                kThreads);
  cp_async_tile(v_s, kRowStride, v + base, ld, lp, kHeadDim, seq_len, tid,
                kThreads);
  cp_async_tile(q_s, kRowStride, q + base + q0 * ld, ld, kTile, kHeadDim,
                seq_len - q0, tid, kThreads);
  cp_async_tile(do_s, kRowStride, dout + base + q0 * ld, ld, kTile, kHeadDim,
                seq_len - q0, tid, kThreads);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r0 = warp * 16;
  if (q0 + r0 >= seq_len) return;  // whole warp past L (no barrier follows)

  uint32_t qa[4][4], da[4][4];
  load_a4(qa, q_s, r0, lane);
  load_a4(da, do_s, r0, lane);

  // Pass 1: per lane and row (lo = g, hi = g + 8) a running max, the sum
  // of exp and the sum of dP * exp, rescaled when the max grows.
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f}, pe[2] = {0.f, 0.f};
  for (int kb = 0; kb < lp; kb += 16) {
    float s[2][4], p[2][4];
    dot_rows(s, qa, k_s, kb, lane);
    dot_rows(p, da, v_s, kb, lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kb + nt * 8 + t4 * 2 + (i & 1);
        s[nt][i] = key < seq_len ? s[nt][i] * scale : -CUDART_INF_F;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the row: fragment elements 2h, 2h + 1
      const float n = fmaxf(m[h], fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]),
                                        fmaxf(s[1][2 * h], s[1][2 * h + 1])));
      if (n > -CUDART_INF_F) {  // else every key so far is masked
        const float a = expf(m[h] - n);
        float le = 0.f, pee = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float e = expf(s[nt][2 * h + j] - n);
            le += e;
            pee += p[nt][2 * h + j] * e;
          }
        }
        l[h] = l[h] * a + le;
        pe[h] = pe[h] * a + pee;
        m[h] = n;
      }
    }
  }
  float row_m[2], r[2], c[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_m[h] = quad_max(m[h]);
    const float f = expf(m[h] - row_m[h]);  // 0 for a lane without keys
    r[h] = 1.f / quad_sum(l[h] * f);
    c[h] = quad_sum(pe[h] * f) * r[h];
  }
  const int row_lo = q0 + r0 + g;
  if (t4 == 0) {
    const size_t rc = (static_cast<size_t>(batch) * num_heads + head) *
                      seq_len;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_lo + 8 * h;
      if (row < seq_len) {
        m_out[rc + row] = row_m[h];
        r_out[rc + row] = r[h];
        c_out[rc + row] = c[h];
      }
    }
  }

  // Pass 2: dS for each key block, then dQ += dS K.
  float acc[8][4];
  zero_acc(acc);
  for (int kb = 0; kb < lp; kb += 16) {
    float s[2][4], p[2][4];
    dot_rows(s, qa, k_s, kb, lane);
    dot_rows(p, da, v_s, kb, lane);
    uint32_t pa[4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kb + nt * 8 + t4 * 2 + (i & 1);
        const int h = i >> 1;
        const float prob =
            key < seq_len ? expf(s[nt][i] * scale - row_m[h]) * r[h] : 0.f;
        ds[i] = prob * (p[nt][i] - c[h]);
      }
      pa[nt * 2 + 0] = pack_bf16(ds[0], ds[1]);
      pa[nt * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    acc_rows(acc, pa, k_s, kb, lane);
  }
  store_rows(dq + base, ld, row_lo, seq_len, acc, scale, scale, lane);
}

__global__ void __launch_bounds__(kThreads)
attn_unpacked_bwd_dkdv(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv,
                       const float* __restrict__ m_in,
                       const float* __restrict__ r_in,
                       const float* __restrict__ c_in, int seq_len,
                       int num_heads, int lp, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* do_s = q_s + lp * kRowStride;
  __nv_bfloat16* k_s = do_s + lp * kRowStride;
  __nv_bfloat16* v_s = k_s + kTile * kRowStride;
  float* m_s = reinterpret_cast<float*>(v_s + kTile * kRowStride);
  float* r_s = m_s + lp;
  float* c_s = r_s + lp;

  const int k0 = blockIdx.x * kTile;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const size_t ld = static_cast<size_t>(num_heads) * kHeadDim;
  const size_t base = static_cast<size_t>(batch) * seq_len * ld +
                      static_cast<size_t>(head) * kHeadDim;
  const size_t rc = (static_cast<size_t>(batch) * num_heads + head) * seq_len;
  const int tid = threadIdx.x;

  cp_async_tile(q_s, kRowStride, q + base, ld, lp, kHeadDim, seq_len, tid,
                kThreads);
  cp_async_tile(do_s, kRowStride, dout + base, ld, lp, kHeadDim, seq_len, tid,
                kThreads);
  cp_async_tile(k_s, kRowStride, k + base + k0 * ld, ld, kTile, kHeadDim,
                seq_len - k0, tid, kThreads);
  cp_async_tile(v_s, kRowStride, v + base + k0 * ld, ld, kTile, kHeadDim,
                seq_len - k0, tid, kThreads);
  cp_async_commit();
  // Queries past L get r = 0 (no probability) and finite m and c.
  for (int j = tid; j < lp; j += kThreads) {
    const bool ok = j < seq_len;
    m_s[j] = ok ? m_in[rc + j] : 0.f;
    r_s[j] = ok ? r_in[rc + j] : 0.f;
    c_s[j] = ok ? c_in[rc + j] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r0 = warp * 16;
  if (k0 + r0 >= seq_len) return;  // whole warp past L (no barrier follows)

  uint32_t ka[4][4], va[4][4];
  load_a4(ka, k_s, r0, lane);
  load_a4(va, v_s, r0, lane);

  float acc_k[8][4], acc_v[8][4];
  zero_acc(acc_k);
  zero_acc(acc_v);
  for (int qb = 0; qb < lp; qb += 16) {
    float s[2][4], p[2][4];  // S^T = K Q^T and dP^T = V dO^T: keys x queries
    dot_rows(s, ka, q_s, qb, lane);
    dot_rows(p, va, do_s, qb, lane);
    uint32_t pa[4], dsa[4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float pv[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = qb + nt * 8 + t4 * 2 + (i & 1);
        // A key row past L (not stored) may overflow here; rows of a
        // product do not mix, so it stays in that row.
        pv[i] = expf(s[nt][i] * scale - m_s[qi]) * r_s[qi];
        ds[i] = pv[i] * (p[nt][i] - c_s[qi]);
      }
      pa[nt * 2 + 0] = pack_bf16(pv[0], pv[1]);
      pa[nt * 2 + 1] = pack_bf16(pv[2], pv[3]);
      dsa[nt * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsa[nt * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    acc_rows(acc_v, pa, do_s, qb, lane);
    acc_rows(acc_k, dsa, q_s, qb, lane);
  }
  const int key_lo = k0 + r0 + g;
  store_rows(dk + base, ld, key_lo, seq_len, acc_k, scale, scale, lane);
  store_rows(dv + base, ld, key_lo, seq_len, acc_v, 1.f, 1.f, lane);
}

}  // namespace

// Largest sequence length the kernels take (the larger of their shared
// memory needs must fit in the 227 KB a block can use).
extern "C" int attention_unpacked_bwd_max_len() {
  int lp = 16;
  while (dkv_smem_bytes(lp + 16) <= 232448) lp += 16;
  return lp;
}

// q, k, v, dout, dq, dk, dv: [B, L, H, 64] bf16, contiguous, 16-byte
// aligned. m, r, c: (B, H, L) f32 scratch that kernel (a) fills and (b)
// reads. scale = 64**-0.5 in f32. Returns cudaGetLastError().
extern "C" int attention_unpacked_bwd(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      void* dq, void* dk, void* dv, void* m,
                                      void* r, void* c, int batch,
                                      int seq_len, int num_heads, float scale,
                                      void* stream) {
  const int lp = (seq_len + 15) / 16 * 16;
  if (lp > attention_unpacked_bwd_max_len()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem_a = dq_smem_bytes(lp);
  const size_t smem_b = dkv_smem_bytes(lp);
  cudaError_t err = cudaFuncSetAttribute(
      attn_unpacked_bwd_dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_a));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attn_unpacked_bwd_dkdv,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_b));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((seq_len + kTile - 1) / kTile, num_heads, batch);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* db = static_cast<const __nv_bfloat16*>(dout);
  auto* mf = static_cast<float*>(m);
  auto* rf = static_cast<float*>(r);
  auto* cf = static_cast<float*>(c);
  attn_unpacked_bwd_dq<<<grid, kThreads, smem_a, s>>>(
      qb, kb, vb, db, static_cast<__nv_bfloat16*>(dq), mf, rf, cf, seq_len,
      num_heads, lp, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_unpacked_bwd_dkdv<<<grid, kThreads, smem_b, s>>>(
      qb, kb, vb, db, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), mf, rf, cf, seq_len, num_heads, lp,
      scale);
  return static_cast<int>(cudaGetLastError());
}
