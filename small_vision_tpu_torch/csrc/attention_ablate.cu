// Packed (B, L, H*64) bf16 attention under one of seven softmax / matmul
// arms, forward only, for Hopper (sm_90a): the ablation kernel that tells
// where an attention kernel's time goes.
//
// Replaces: scripts/ablate_attention_kernel.py::_kernel_variant (reached via
// run_variant). One kernel template, the arm a compile-time parameter. With
// S = (Q K^T) * scale in f32 and lp = L rounded up to 16 (the TPU tile; its
// columns past L hold keys that are zero, so they score exactly 0):
//   prod       S masked to -inf past L; m = rowmax; e = exp(S - m);
//              p = bf16(e / rowsum(e))
//   nosoftmax  p = bf16(S * 0.001), no mask (keys past L are zero rows)
//   nomm       no QK product: S[i][j] = f32(bf16(q[i][0] * scale)) for every
//              j, then prod's softmax; out[i][:] = bf16(p[i][0] * v[i][0])
//              on all 64 columns of the head (query row i's own v)
//   bf16exp    prod with e = bf16(exp(bf16(S - m))), summed in f32
//   exp2       S * log2(e), masked; e = exp2(S - m)
//   mulmask    m = rowmax over all lp columns (a 0 joins the max when L is
//              not a multiple of 16); e = exp(S - m) * [key < L]
//   nomax      e = exp(S) * [key < L], unshifted
// Every arm but nosoftmax divides the (L, L) e by its f32 row sum, and every
// arm rounds p to bf16 before the PV product, which accumulates in f32.
// bf16exp: the TPU kernel takes exp of a bf16 array; here exp is taken in
// f32 of the rounded argument and its result rounded to bf16, which is how
// a CPU evaluates the bf16 exp.
//
// Bound on this card: at B=128, H=12, L=257 the 4*B*L*768*2 bytes of q, k,
// v and o (202 MB, 0.060 ms at 3.35 TB/s) outweigh the 4*B*H*L^2*64 flops
// (26 GFLOP, 0.026 ms at 989 TFLOP/s); the exp of every score, taken once
// for the row sum and once for p, is the next limit.
//
// Design: the block of attention_unpacked.cu (64 query rows of one (batch,
// head), the head's K and V staged row-major in shared memory, four warps
// of 16 rows), but the softmax is kept as the TPU body has it, one
// reduction after the other over a full row, instead of one online pass:
// pass 1 takes the row max (arms that shift), pass 2 the row sum of e with
// the final max, pass 3 forms p, rounds it and multiplies by V. Each pass
// recomputes S from the Q fragments in the same way, so e has the same
// bits in pass 2 and pass 3 and the sum is the sum of the very e
// that are normalised. K rows past L are zero-filled in shared memory and
// every pass runs over lp keys, so padded keys score exactly 0 as on the
// TPU tile.

#include <math_constants.h>

#include "attention_maxshift.cuh"

namespace {

using namespace tiles;

constexpr int kHeadDim = 64;
constexpr int kQTile = 64;
constexpr int kThreads = 128;

enum Arm {
  kProd = 0,
  kNoSoftmax = 1,
  kNoMM = 2,
  kBf16Exp = 3,
  kExp2 = 4,
  kMulMask = 5,
  kNoMax = 6,
  kNumArms = 7
};

__host__ __device__ constexpr bool shifts(int arm) {
  return arm != kNoSoftmax && arm != kNoMax;
}
// Arms that mask keys past L to -inf before the max.
__host__ __device__ constexpr bool masks_inf(int arm) {
  return arm == kProd || arm == kNoMM || arm == kBf16Exp || arm == kExp2;
}

__host__ __device__ constexpr size_t smem_bytes(int lk_pad) {
  return sizeof(__nv_bfloat16) * kRowStride *
         (2 * static_cast<size_t>(lk_pad) + kQTile);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The arm's f32 scores of the warp's 16 rows against keys kb..kb+15, in
// the layout of two (m16, n8) accumulators; keys past L already masked
// where the arm masks before the max.
template <int kArm>
__device__ __forceinline__ void arm_scores(float (&s)[2][4],
                                           const uint32_t (&qa)[4][4],
                                           const __nv_bfloat16* k_s, int kb,
                                           int seq_len, float scale,
                                           float bcast_lo, float bcast_hi,
                                           int lane) {
  const int t4 = lane & 3;
  if constexpr (kArm == kNoMM) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = i < 2 ? bcast_lo : bcast_hi;
        // Opaque to the compiler, so that the softmax of every key stays in
        // the loop although the scores of a row are all equal.
        asm volatile("" : "+f"(x));
        s[nt][i] = x;
      }
    }
  } else {
    dot_rows(s, qa, k_s, kb, lane);
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (kArm != kNoMM) s[nt][i] *= scale;
      if constexpr (kArm == kExp2) s[nt][i] *= 1.4426950408889634f;
      if constexpr (masks_inf(kArm)) {
        const int key = kb + nt * 8 + t4 * 2 + (i & 1);
        if (key >= seq_len) s[nt][i] = -CUDART_INF_F;
      }
    }
  }
}

// e of one score under the arm, given the row's shift m.
template <int kArm>
__device__ __forceinline__ float arm_e(float s, float m, bool valid) {
  if constexpr (kArm == kBf16Exp) {
    return round_bf16(expf(round_bf16(s - m)));
  } else if constexpr (kArm == kExp2) {
    return exp2f(s - m);
  } else if constexpr (kArm == kMulMask) {
    return expf(s - m) * (valid ? 1.f : 0.f);
  } else if constexpr (kArm == kNoMax) {
    return expf(s) * (valid ? 1.f : 0.f);
  } else {
    return expf(s - m);
  }
}

template <int kArm>
__global__ void __launch_bounds__(kThreads)
attention_ablate_kernel(const __nv_bfloat16* __restrict__ q,
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

  // Rows past L are zero-filled, as the TPU body zeroes them at the source.
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
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;
  if (q0 + r0 >= seq_len) return;  // whole warp past L (no barrier follows)

  uint32_t qa[4][4] = {};
  float bcast_lo = 0.f, bcast_hi = 0.f;
  if constexpr (kArm == kNoMM) {
    bcast_lo = round_bf16(
        __bfloat162float(q_s[(r0 + g) * kRowStride]) * scale);
    bcast_hi = round_bf16(
        __bfloat162float(q_s[(r0 + g + 8) * kRowStride]) * scale);
  } else {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      load_a(qa[ks], q_s, kRowStride, r0, ks * 16, lane);
    }
  }

  // Pass 1: the row max, rows g (lo) and g + 8 (hi).
  float m_lo = 0.f, m_hi = 0.f;
  if constexpr (shifts(kArm)) {
    m_lo = m_hi = -CUDART_INF_F;
    for (int kb = 0; kb < lk_pad; kb += 16) {
      float s[2][4];
      arm_scores<kArm>(s, qa, k_s, kb, seq_len, scale, bcast_lo, bcast_hi,
                       lane);
      m_lo = fmaxf(m_lo, fmaxf(fmaxf(s[0][0], s[0][1]),
                               fmaxf(s[1][0], s[1][1])));
      m_hi = fmaxf(m_hi, fmaxf(fmaxf(s[0][2], s[0][3]),
                               fmaxf(s[1][2], s[1][3])));
    }
    m_lo = quad_max(m_lo);
    m_hi = quad_max(m_hi);
  }

  // Pass 2: the f32 row sum of e.
  float sum_lo = 1.f, sum_hi = 1.f;
  if constexpr (kArm != kNoSoftmax) {
    sum_lo = sum_hi = 0.f;
    for (int kb = 0; kb < lk_pad; kb += 16) {
      float s[2][4];
      arm_scores<kArm>(s, qa, k_s, kb, seq_len, scale, bcast_lo, bcast_hi,
                       lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool valid = kb + nt * 8 + t4 * 2 + (i & 1) < seq_len;
          const float e = arm_e<kArm>(s[nt][i], i < 2 ? m_lo : m_hi, valid);
          if (i < 2) sum_lo += e; else sum_hi += e;
        }
      }
    }
    sum_lo = quad_sum(sum_lo);
    sum_hi = quad_sum(sum_hi);
  }

  // Pass 3: p, rounded, times V. nomm reads p of key 0 alone (held by the
  // lanes with t4 == 0 in the first block), so it forms no other.
  float acc[8][4];
  zero_acc(acc);
  const int kb_end = kArm == kNoMM ? 16 : lk_pad;
  for (int kb = 0; kb < kb_end; kb += 16) {
    float s[2][4];
    arm_scores<kArm>(s, qa, k_s, kb, seq_len, scale, bcast_lo, bcast_hi,
                     lane);
    float p[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (kArm == kNoSoftmax) {
          p[nt][i] = s[nt][i] * 0.001f;
        } else {
          const bool valid = kb + nt * 8 + t4 * 2 + (i & 1) < seq_len;
          p[nt][i] = arm_e<kArm>(s[nt][i], i < 2 ? m_lo : m_hi, valid) /
                     (i < 2 ? sum_lo : sum_hi);
        }
      }
    }
    if constexpr (kArm == kNoMM) {
      // bf16(p[i][0]) * v[i][0]: a product of two bf16 is exact in f32, and
      // the store rounds it once.
      const int src = lane & ~3;
      const float p_lo =
          __shfl_sync(0xffffffffu, round_bf16(p[0][0]), src);
      const float p_hi =
          __shfl_sync(0xffffffffu, round_bf16(p[0][2]), src);
      const float o_lo =
          p_lo * __bfloat162float(v_s[(q0 + r0 + g) * kRowStride]);
      const float o_hi =
          p_hi * __bfloat162float(v_s[(q0 + r0 + g + 8) * kRowStride]);
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        acc[dt][0] = acc[dt][1] = o_lo;
        acc[dt][2] = acc[dt][3] = o_hi;
      }
    } else {
      uint32_t pa[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        pa[nt * 2 + 0] = pack_bf16(p[nt][0], p[nt][1]);
        pa[nt * 2 + 1] = pack_bf16(p[nt][2], p[nt][3]);
      }
      acc_rows(acc, pa, v_s, kb, lane);
    }
  }
  store_rows(o + base, ld, q0 + r0 + g, seq_len, acc, 1.f, 1.f, lane);
}

template <int kArm>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int seq_len, int num_heads, int lk_pad, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(lk_pad);
  cudaError_t err = cudaFuncSetAttribute(
      attention_ablate_kernel<kArm>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq_len + kQTile - 1) / kQTile, num_heads, batch);
  attention_ablate_kernel<kArm><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      seq_len, num_heads, lk_pad, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Largest sequence length the kernel takes (a head's K and V must fit in
// the 227 KB of shared memory a block can use).
extern "C" int attention_ablate_max_len() {
  int lk = 16;
  while (smem_bytes(lk + 16) <= 232448) lk += 16;
  return lk;
}

// q, k, v, o: (B, L, H*64) bf16, contiguous, 16-byte aligned. scale =
// 64**-0.5 in f32. variant: 0 prod, 1 nosoftmax, 2 nomm, 3 bf16exp, 4 exp2,
// 5 mulmask, 6 nomax. Returns cudaGetLastError().
extern "C" int attention_ablate_fwd(const void* q, const void* k,
                                    const void* v, void* o, int batch,
                                    int seq_len, int num_heads, float scale,
                                    int variant, void* stream) {
  const int lk_pad = (seq_len + 15) / 16 * 16;
  if (lk_pad > attention_ablate_max_len() || variant < 0 ||
      variant >= kNumArms) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SV_ARM(A)                                                          \
  case A:                                                                  \
    return launch<A>(q, k, v, o, batch, seq_len, num_heads, lk_pad, scale, \
                     st);
  switch (variant) {
    SV_ARM(kProd)
    SV_ARM(kNoSoftmax)
    SV_ARM(kNoMM)
    SV_ARM(kBf16Exp)
    SV_ARM(kExp2)
    SV_ARM(kMulMask)
    SV_ARM(kNoMax)
  }
#undef SV_ARM
  return static_cast<int>(cudaErrorInvalidValue);
}
