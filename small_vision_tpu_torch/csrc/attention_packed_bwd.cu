// Bidirectional attention on packed (B, L, H*64) bf16 tensors, backward,
// for Hopper (sm_90a).
//
// Replaces: small_vision_tpu/ops/attention.py::_attn_bwd_kernel_packed
// (reached via _pallas_attention_packed_bwd_impl, the custom VJP of
// fused_attention_packed). Per (batch, head), recomputing the forward's e:
//   e  = exp2(clamp(Q K^T * scale * log2(e), -80, 80)) * keymask   (f32)
//   r  = rowmask / rowsum(e)
//   dV = bf16(e)^T bf16(dO * r)
//   dP = dO V^T                                                     (f32)
//   c  = rowsum(dP * e) * r
//   dS = bf16(e * (dP - c))
//   dQ = (dS K) * (r * scale)
//   dK = dS^T bf16(Q * (r * scale))
// with f32 sums and bf16 outputs: the TPU kernel's formulas and its
// rounding points. The clamp is treated as the identity, as there: dS uses
// the clamped e and nothing is zeroed where the clamp bites.
//
// Bound on this card: at the training shapes (B=128, H=12, L up to 257,
// D=64) the 7*B*L*H*D*2 bytes of q, k, v, dO, dq, dk and dv (354 MB at
// L=257, 0.106 ms at 3.35 TB/s) outweigh the 5 products of 2*B*H*L^2*D
// flops (65 GFLOP, 0.066 ms at 989 TFLOP/s); the exp2 of every score,
// recomputed three times below, is the next limit.
//
// Design. dK and dV contract over queries, while r and c need a whole row
// of keys first; the TPU kernel gets both by holding a whole head in VMEM.
// Here the work splits in two kernels, as in FlashAttention-2's backward,
// so that every output element is summed by one thread in a fixed order:
// no atomics, and two launches give the same bits.
//  (a) attn_bwd_dq: one block per (b, h, 64-query tile); four warps own 16
//      query rows each. It stages the head's K (row-major and transposed)
//      and V (row-major) in shared memory, then makes two passes over the
//      keys in blocks of 16: the first sums e and dP*e per row (giving r
//      and c, which it also stores to (B, H, L) f32 buffers), the second
//      forms dS and accumulates dS K in registers.
//  (b) attn_bwd_dkdv: one block per (b, h, 64-key tile); four warps own 16
//      keys each. It stages the head's Q and dO (row-major) and the rounded
//      bf16(dO * r) and bf16(Q * r * scale) (transposed) with r and c from
//      (a), then for each block of 16 queries recomputes e^T = exp2(K Q^T)
//      and dP^T = V dO^T, forms dS^T, and accumulates dV and dK in f32
//      registers.
// Every product is a bf16 mma.sync m16n8k16 with f32 accumulation, as in
// K3; an (m16, n8) accumulator pair is exactly the A fragment of the next
// product, so e and dS go from registers to the tensor cores directly.
// Shared-memory rows are padded by 8 bf16. Inputs are read in place in the
// packed layout; rows past L are staged as zeros and masked. Not yet used:
// wgmma, TMA, staging a head once for several tiles (a later change).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kTile = 64;  // query rows (a) or key rows (b) per block
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowStride = kHeadDim + 8;  // bf16 per row-major shared row
constexpr float kClamp = 80.f;

__host__ __device__ constexpr int t_stride(int l_pad) { return l_pad + 8; }

// (a): K, V row-major [lp][72]; K^T [64][lp+8]; Q, dO tiles [64][72].
__host__ __device__ constexpr size_t dq_smem_bytes(int lp) {
  return sizeof(__nv_bfloat16) *
         (2 * static_cast<size_t>(lp) * kRowStride +
          static_cast<size_t>(kHeadDim) * t_stride(lp) +
          2 * static_cast<size_t>(kTile) * kRowStride);
}

// (b): Q, dO row-major [lp][72]; bf16(dO*r)^T, bf16(Q*r*scale)^T
// [64][lp+8]; K, V tiles [64][72]; then r and c, [lp] f32.
__host__ __device__ constexpr size_t dkv_smem_bytes(int lp) {
  return sizeof(__nv_bfloat16) *
             (2 * static_cast<size_t>(lp) * kRowStride +
              2 * static_cast<size_t>(kHeadDim) * t_stride(lp) +
              2 * static_cast<size_t>(kTile) * kRowStride) +
         sizeof(float) * 2 * static_cast<size_t>(lp);
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragments of rows r0..r0+15 of a row-major [.][72] tile, for the four
// 16-wide steps over the head dim.
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4],
                                       const __nv_bfloat16* tile, int r0,
                                       int g, int t4) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const __nv_bfloat16* p0 = tile + (r0 + g) * kRowStride + ks * 16 + t4 * 2;
    const __nv_bfloat16* p1 = p0 + 8 * kRowStride;
    a[ks][0] = ld32(p0);
    a[ks][1] = ld32(p1);
    a[ks][2] = ld32(p0 + 8);
    a[ks][3] = ld32(p1 + 8);
  }
}

// s = A M^T for 16 rows of A (fragments `a`) against rows cb..cb+15 of a
// row-major [.][72] matrix M: two (m16, n8) accumulators.
__device__ __forceinline__ void dot_rows(float (&s)[2][4],
                                         const uint32_t (&a)[4][4],
                                         const __nv_bfloat16* m, int cb,
                                         int g, int t4) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
    const __nv_bfloat16* mr = m + (cb + nt * 8 + g) * kRowStride + t4 * 2;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      mma_bf16_16816(s[nt], a[ks], ld32(mr + ks * 16), ld32(mr + ks * 16 + 8));
    }
  }
}

// acc (16 x 64) += P N for a 16 x 16 P in A fragments `pa` and rows
// kb..kb+15 of N, held transposed as a [64][ts] matrix NT.
__device__ __forceinline__ void acc_cols(float (&acc)[8][4],
                                         const uint32_t (&pa)[4],
                                         const __nv_bfloat16* nt_s, int ts,
                                         int kb, int g, int t4) {
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const __nv_bfloat16* r = nt_s + (dt * 8 + g) * ts + kb + t4 * 2;
    mma_bf16_16816(acc[dt], pa, ld32(r), ld32(r + 8));
  }
}

__device__ __forceinline__ float exp2_clamped(float s, float scale_log2) {
  return exp2f(fminf(fmaxf(s * scale_log2, -kClamp), kClamp));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ void zero_acc(float (&acc)[8][4]) {
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;
  }
}

// Stores rows lo and lo + 8 of a 16 x 64 f32 accumulator as bf16, times
// f_lo / f_hi, dropping rows at or past seq_len.
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, size_t base,
                                           int tok_stride, int row_lo,
                                           int seq_len, const float (&acc)[8][4],
                                           float f_lo, float f_hi, int t4) {
  __nv_bfloat16* o_lo = out + base + static_cast<size_t>(row_lo) * tok_stride;
  __nv_bfloat16* o_hi = o_lo + 8 * static_cast<size_t>(tok_stride);
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int col = dt * 8 + t4 * 2;
    if (row_lo < seq_len) {
      *reinterpret_cast<uint32_t*>(o_lo + col) =
          pack_bf16(acc[dt][0] * f_lo, acc[dt][1] * f_lo);
    }
    if (row_lo + 8 < seq_len) {
      *reinterpret_cast<uint32_t*>(o_hi + col) =
          pack_bf16(acc[dt][2] * f_hi, acc[dt][3] * f_hi);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
attn_bwd_dq(const __nv_bfloat16* __restrict__ q,
            const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v,
            const __nv_bfloat16* __restrict__ dout,
            __nv_bfloat16* __restrict__ dq, float* __restrict__ r_out,
            float* __restrict__ c_out, int seq_len, int num_heads, int lp,
            float scale_log2, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ts = t_stride(lp);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + lp * kRowStride;
  __nv_bfloat16* kt_s = v_s + lp * kRowStride;   // [64][ts]
  __nv_bfloat16* q_s = kt_s + kHeadDim * ts;     // [64][72]
  __nv_bfloat16* do_s = q_s + kTile * kRowStride;

  const int q0 = blockIdx.x * kTile;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int tok_stride = num_heads * kHeadDim;
  const size_t base = static_cast<size_t>(batch) * seq_len * tok_stride +
                      static_cast<size_t>(head) * kHeadDim;
  const int tid = threadIdx.x;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  for (int idx = tid; idx < lp * 8; idx += kThreads) {
    const int j = idx >> 3;
    const int c = (idx & 7) * 8;
    uint4 kv = zero4, vv = zero4;
    if (j < seq_len) {
      const size_t off = base + static_cast<size_t>(j) * tok_stride + c;
      kv = *reinterpret_cast<const uint4*>(k + off);
      vv = *reinterpret_cast<const uint4*>(v + off);
    }
    *reinterpret_cast<uint4*>(k_s + j * kRowStride + c) = kv;
    *reinterpret_cast<uint4*>(v_s + j * kRowStride + c) = vv;
    const __nv_bfloat16* ke = reinterpret_cast<const __nv_bfloat16*>(&kv);
#pragma unroll
    for (int e = 0; e < 8; ++e) kt_s[(c + e) * ts + j] = ke[e];
  }
  for (int idx = tid; idx < kTile * 8; idx += kThreads) {
    const int r = idx >> 3;
    const int c = (idx & 7) * 8;
    uint4 qv = zero4, dv = zero4;
    if (q0 + r < seq_len) {
      const size_t off = base + static_cast<size_t>(q0 + r) * tok_stride + c;
      qv = *reinterpret_cast<const uint4*>(q + off);
      dv = *reinterpret_cast<const uint4*>(dout + off);
    }
    *reinterpret_cast<uint4*>(q_s + r * kRowStride + c) = qv;
    *reinterpret_cast<uint4*>(do_s + r * kRowStride + c) = dv;
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r0 = warp * 16;
  if (q0 + r0 >= seq_len) return;  // whole warp past L (no barrier follows)

  uint32_t qa[4][4], da[4][4];
  load_a(qa, q_s, r0, g, t4);
  load_a(da, do_s, r0, g, t4);

  // Pass 1: row sums of e and of dP * e (rows g and g + 8, this lane's keys).
  float s_lo = 0.f, s_hi = 0.f, pe_lo = 0.f, pe_hi = 0.f;
  for (int kb = 0; kb < lp; kb += 16) {
    float s[2][4], p[2][4];
    dot_rows(s, qa, k_s, kb, g, t4);
    dot_rows(p, da, v_s, kb, g, t4);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kb + nt * 8 + t4 * 2 + (i & 1);
        const float e = key < seq_len ? exp2_clamped(s[nt][i], scale_log2)
                                      : 0.f;
        if (i < 2) {
          s_lo += e;
          pe_lo += p[nt][i] * e;
        } else {
          s_hi += e;
          pe_hi += p[nt][i] * e;
        }
      }
    }
  }
  s_lo = quad_sum(s_lo);
  s_hi = quad_sum(s_hi);
  pe_lo = quad_sum(pe_lo);
  pe_hi = quad_sum(pe_hi);
  const int row_lo = q0 + r0 + g;
  const int row_hi = row_lo + 8;
  const float r_lo = row_lo < seq_len ? 1.f / s_lo : 0.f;
  const float r_hi = row_hi < seq_len ? 1.f / s_hi : 0.f;
  const float c_lo = pe_lo * r_lo;
  const float c_hi = pe_hi * r_hi;
  if (t4 == 0) {
    const size_t rc = (static_cast<size_t>(batch) * num_heads + head) *
                      seq_len;
    if (row_lo < seq_len) {
      r_out[rc + row_lo] = r_lo;
      c_out[rc + row_lo] = c_lo;
    }
    if (row_hi < seq_len) {
      r_out[rc + row_hi] = r_hi;
      c_out[rc + row_hi] = c_hi;
    }
  }

  // Pass 2: dS for each key block, then dQ += dS K.
  float acc[8][4];
  zero_acc(acc);
  for (int kb = 0; kb < lp; kb += 16) {
    float s[2][4], p[2][4];
    dot_rows(s, qa, k_s, kb, g, t4);
    dot_rows(p, da, v_s, kb, g, t4);
    uint32_t pa[4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kb + nt * 8 + t4 * 2 + (i & 1);
        const float e = key < seq_len ? exp2_clamped(s[nt][i], scale_log2)
                                      : 0.f;
        ds[i] = e * (p[nt][i] - (i < 2 ? c_lo : c_hi));
      }
      pa[nt * 2 + 0] = pack_bf16(ds[0], ds[1]);
      pa[nt * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    acc_cols(acc, pa, kt_s, ts, kb, g, t4);
  }
  store_rows(dq, base, tok_stride, row_lo, seq_len, acc, r_lo * scale,
             r_hi * scale, t4);
}

__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ dout,
              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
              const float* __restrict__ r_in, const float* __restrict__ c_in,
              int seq_len, int num_heads, int lp, float scale_log2,
              float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ts = t_stride(lp);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* do_s = q_s + lp * kRowStride;
  __nv_bfloat16* dort_s = do_s + lp * kRowStride;  // bf16(dO*r)^T [64][ts]
  __nv_bfloat16* qrst_s = dort_s + kHeadDim * ts;  // bf16(Q*r*scale)^T
  __nv_bfloat16* k_s = qrst_s + kHeadDim * ts;     // [64][72]
  __nv_bfloat16* v_s = k_s + kTile * kRowStride;
  float* r_s = reinterpret_cast<float*>(v_s + kTile * kRowStride);
  float* c_s = r_s + lp;

  const int k0 = blockIdx.x * kTile;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int tok_stride = num_heads * kHeadDim;
  const size_t base = static_cast<size_t>(batch) * seq_len * tok_stride +
                      static_cast<size_t>(head) * kHeadDim;
  const size_t rc = (static_cast<size_t>(batch) * num_heads + head) * seq_len;
  const int tid = threadIdx.x;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  // r and c of every query; queries past L get 0 (their e is masked too).
  for (int j = tid; j < lp; j += kThreads) {
    r_s[j] = j < seq_len ? r_in[rc + j] : 0.f;
    c_s[j] = j < seq_len ? c_in[rc + j] : 0.f;
  }
  __syncthreads();
  for (int idx = tid; idx < lp * 8; idx += kThreads) {
    const int j = idx >> 3;
    const int c = (idx & 7) * 8;
    uint4 qv = zero4, dv4 = zero4;
    if (j < seq_len) {
      const size_t off = base + static_cast<size_t>(j) * tok_stride + c;
      qv = *reinterpret_cast<const uint4*>(q + off);
      dv4 = *reinterpret_cast<const uint4*>(dout + off);
    }
    *reinterpret_cast<uint4*>(q_s + j * kRowStride + c) = qv;
    *reinterpret_cast<uint4*>(do_s + j * kRowStride + c) = dv4;
    const float rj = r_s[j];
    const float rsj = rj * scale;
    const __nv_bfloat16* qe = reinterpret_cast<const __nv_bfloat16*>(&qv);
    const __nv_bfloat16* de = reinterpret_cast<const __nv_bfloat16*>(&dv4);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      dort_s[(c + e) * ts + j] = __float2bfloat16_rn(__bfloat162float(de[e]) *
                                                     rj);
      qrst_s[(c + e) * ts + j] = __float2bfloat16_rn(__bfloat162float(qe[e]) *
                                                     rsj);
    }
  }
  for (int idx = tid; idx < kTile * 8; idx += kThreads) {
    const int r = idx >> 3;
    const int c = (idx & 7) * 8;
    uint4 kv = zero4, vv = zero4;
    if (k0 + r < seq_len) {
      const size_t off = base + static_cast<size_t>(k0 + r) * tok_stride + c;
      kv = *reinterpret_cast<const uint4*>(k + off);
      vv = *reinterpret_cast<const uint4*>(v + off);
    }
    *reinterpret_cast<uint4*>(k_s + r * kRowStride + c) = kv;
    *reinterpret_cast<uint4*>(v_s + r * kRowStride + c) = vv;
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r0 = warp * 16;
  if (k0 + r0 >= seq_len) return;  // whole warp past L (no barrier follows)

  uint32_t ka[4][4], va[4][4];
  load_a(ka, k_s, r0, g, t4);
  load_a(va, v_s, r0, g, t4);

  float acc_k[8][4], acc_v[8][4];
  zero_acc(acc_k);
  zero_acc(acc_v);
  for (int qb = 0; qb < lp; qb += 16) {
    float s[2][4], p[2][4];  // S^T = K Q^T and dP^T = V dO^T: keys x queries
    dot_rows(s, ka, q_s, qb, g, t4);
    dot_rows(p, va, do_s, qb, g, t4);
    uint32_t ea[4], dsa[4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float ev[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = qb + nt * 8 + t4 * 2 + (i & 1);
        ev[i] = qi < seq_len ? exp2_clamped(s[nt][i], scale_log2) : 0.f;
        ds[i] = ev[i] * (p[nt][i] - c_s[qi]);
      }
      ea[nt * 2 + 0] = pack_bf16(ev[0], ev[1]);
      ea[nt * 2 + 1] = pack_bf16(ev[2], ev[3]);
      dsa[nt * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsa[nt * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    acc_cols(acc_v, ea, dort_s, ts, qb, g, t4);
    acc_cols(acc_k, dsa, qrst_s, ts, qb, g, t4);
  }
  const int key_lo = k0 + r0 + g;
  store_rows(dk, base, tok_stride, key_lo, seq_len, acc_k, 1.f, 1.f, t4);
  store_rows(dv, base, tok_stride, key_lo, seq_len, acc_v, 1.f, 1.f, t4);
}

}  // namespace

// Largest sequence length the kernels take (the larger of their shared
// memory needs must fit in the 227 KB a block can use).
extern "C" int attention_packed_bwd_max_len() {
  int lp = 16;
  while (dkv_smem_bytes(lp + 16) <= 232448 &&
         dq_smem_bytes(lp + 16) <= 232448) {
    lp += 16;
  }
  return lp;
}

// q, k, v, dout, dq, dk, dv: (B, L, H*64) bf16, contiguous, 16-byte
// aligned. r, c: (B, H, L) f32 scratch that kernel (a) fills and (b) reads.
// scale_log2 = head_dim**-0.5 * log2(e) and scale = head_dim**-0.5, in f32.
// Returns cudaGetLastError().
extern "C" int attention_packed_bwd(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    void* dq, void* dk, void* dv, void* r,
                                    void* c, int batch, int seq_len,
                                    int num_heads, float scale_log2,
                                    float scale, void* stream) {
  const int lp = (seq_len + 15) / 16 * 16;
  if (lp > attention_packed_bwd_max_len()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem_a = dq_smem_bytes(lp);
  const size_t smem_b = dkv_smem_bytes(lp);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_a));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attn_bwd_dkdv,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_b));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((seq_len + kTile - 1) / kTile, num_heads, batch);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* db = static_cast<const __nv_bfloat16*>(dout);
  auto* rf = static_cast<float*>(r);
  auto* cf = static_cast<float*>(c);
  attn_bwd_dq<<<grid, kThreads, smem_a, s>>>(
      qb, kb, vb, db, static_cast<__nv_bfloat16*>(dq), rf, cf, seq_len,
      num_heads, lp, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dkdv<<<grid, kThreads, smem_b, s>>>(
      qb, kb, vb, db, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), rf, cf, seq_len, num_heads, lp,
      scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}
