// LayerNorm + AdaLN modulate, backward, for Hopper (sm_90a).
//
// Replaces: small_vision_tpu/ops/layernorm.py::_ln_bwd_kernel (reached via
// _ln_bwd, the custom VJP of fused_ln_modulate). From the saved f32 mean
// and rstd of the forward (K1), per row of D features:
//   xhat = (x - mean) * rstd
//   d_ln = dy * (1 + scale[b])             (dy without modulation)
//   dxhat = d_ln * gamma
//   dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
// and the parameter gradients, summed over rows:
//   dgamma = sum(d_ln * xhat), dbeta = sum(d_ln)              over B and L
//   dshift[b] = sum_L dy, dscale[b] = sum_L dy * (xhat*gamma + beta)
// all in f32; dx is stored in bf16, the sums in f32. The sums are those of
// the TPU kernel regrouped: with A = sum_L dy and C = sum_L dy * xhat per
// batch row and column, dshift = A, dscale = gamma * C + beta * A, dgamma =
// sum_b (1 + scale[b]) * C and dbeta = sum_b (1 + scale[b]) * A. So they
// agree with it to f32 rounding, not bit for bit.
//
// Bound on this card: memory. It reads x and dy and writes dx, 6 bytes an
// element (152 MB at B=128, L=257, D=768: 0.0456 ms at 3.35 TB/s), against
// ~14 f32 operations an element: far under the card's operations-per-byte
// balance. So the design keeps enough bytes in flight on every SM.
//
// Design. One CTA per batch row b, eight warps, and a team of T threads
// per row of D columns: T = 32 (one warp) for 256 < D <= 1,024; for
// narrower rows T = 4, 8 or 16 lanes, so that a warp holds 32 / T rows at
// once rather than leaving lanes without a column; for D > 1,024 T = 64,
// two warps that take half a row each, so that a lane's registers stay
// those of D = 1,024. The CTA's 256 / T teams take the rows k, k + 256/T,
// ... of b; each warp's part of its step (its 32 / T whole rows, or its half
// row) of x and dy reaches shared memory by bulk asynchronous copies
// (cp.async.bulk, one contiguous span each, completion counted on an
// mbarrier) through a ring of four steps, so three more steps are in
// flight while the warp reduces one: 72-128 KB an SM. Each lane holds NV
// vectors of 8 values of its row (16-byte loads from shared memory); where
// its team's lanes do not divide the row's vectors, the last are masked,
// and no lane reads past its row. The lane also holds the mean and rstd of
// one of its warp's next 32 rows, loaded a chunk ahead. The row's two
// reductions are shuffles within the team (and, for T = 64, one exchange
// of the two warps' sums through shared memory at a 64-thread named
// barrier, added in warp order); dx leaves from registers in 16-byte
// stores. The lane keeps A and C of its columns in registers over its
// rows; the CTA adds its teams' in a fixed order through shared memory
// (the ring, once drained), writes dshift[b] and dscale[b], and leaves one
// (2, D) partial, (1 + scale[b]) * (C, A).
//
// The sums over b run in the same launch. The TPU kernel carries dgamma and
// dbeta across its sequential grid; here CTAs run in no order, and atomics
// on the sums would make them depend on it. Instead each CTA, having
// written its partial, takes a ticket from a counter of its group of 16
// batch rows (atomicAdd); the group's last CTA adds the group's partials in
// the order of b into a group partial, and takes a ticket from one more
// counter; the last group's last CTA adds the group partials in group
// order into dgamma and dbeta. Only the tickets are atomic, so every sum
// has a fixed order whichever CTA comes last, and two launches give the
// same bits. The counters belong to the launch: they are the tail of its
// `work` buffer, zeroed on its stream just before the kernel, so launches
// in flight on several streams at once share none. Two levels
// keep the serial tail short: one CTA summing all 128 partials would read
// 786 KB through one SM after every other CTA has finished; a group's last
// CTA reads 98 KB while other CTAs still run, the very last 49 KB.
//
// Every other input runs `ln_modulate_bwd_any_kernel` (the entry point
// `ln_modulate_bwd_any`): x, dy, dx and scale in f32 (the TPU kernel is
// generic in x's dtype), and bf16 rows of any other width, from 1 to
// 8,192. Its element type E is a template parameter; the statistics,
// gamma, beta and every sum stay f32. The caller gives the vector VEC (1,
// 2, 4 or 8 elements, at most 16 bytes) that divides the width and the
// modulation's row stride and to which every pointer is aligned, so rows
// of any width are read and written in place, unpadded. It keeps this
// kernel's plan (one CTA per batch row, the same partials, tickets and
// fixed-order sums over the batch in the same work buffer, so two launches
// give the same bits) with a simpler pipe: the lanes load their row from
// device memory, no bulk copies (whose spans must be multiples of 16 bytes
// at 16-byte aligned addresses, which a row of another width is not). A
// row of up to 1,024 columns is one warp's (32 values a lane); past that
// kW = 2, 4 or 8 warps share it, and its two sums cross the warps through
// shared memory in warp order. The teams' column sums are added in team
// order through shared memory (2 d f32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sv_vec.cuh"

#include "sm90.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;   // steps of a warp in its ring
constexpr int kGroup = 16;   // batch rows of a first-level sum
constexpr int kMaxGroups = 4096;
constexpr int kMaxWidth = 2048;

__host__ __device__ constexpr int num_groups(int batch) {
  return (batch + kGroup - 1) / kGroup;
}

// Threads a row for a width d (a multiple of 32): two warps above 1,024
// columns, else the largest power of two up to 32 that is at most d / 8.
__host__ __device__ constexpr int team_threads(int d) {
  if (d > 1024) return 64;
  int t = 32;
  while (t > d / 8) t >>= 1;
  return t;
}

// Bytes of x (and of dy) a warp takes a step: 32 / T rows, or half a row.
__host__ __device__ constexpr int slice_bytes(int t, int d) {
  return t <= 32 ? (32 / t) * d * 2 : d;
}

__host__ __device__ constexpr size_t ring_bytes(int t, int d) {
  return static_cast<size_t>(kWarps) * kStages * 2 * slice_bytes(t, d);
}

// `bytes` (a multiple of 16) from global to shared memory, both 16-byte
// aligned; completion is counted on `bar` in bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(sm90::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(sm90::smem_u32(bar))
      : "memory");
}

// The sum over the aligned group of `lanes` lanes (a power of two <= 32).
template <int kLanes>
__device__ __forceinline__ float team_sum(float v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__device__ __forceinline__ void load8(const void* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

// The CTA's ticket from `counter`; true for the last of `count` takers,
// which then sees every taker's writes.
__device__ __forceinline__ bool last_to_arrive(unsigned int* counter,
                                               unsigned int count,
                                               unsigned int* ticket) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *ticket = atomicAdd(counter, 1u);
  __syncthreads();
  const bool last = *ticket == count - 1;
  if (last) __threadfence();
  return last;
}

// acc[t] = the sum over k < count, in the order of k, of
// base[k * 2 d + threadIdx.x + t * kThreads] (0 past 2 d): kK rows' loads
// are issued before their adds (the partials were written by other CTAs,
// so they are read from L2).
template <int kPer>
__device__ __forceinline__ void sum_partials(const float* base, int count,
                                             int d, float (&acc)[kPer]) {
  constexpr int kK = kPer <= 8 ? kGroup : 8;
#pragma unroll
  for (int t = 0; t < kPer; ++t) acc[t] = 0.f;
  for (int k0 = 0; k0 < count; k0 += kK) {
    float v[kPer][kK];
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int idx = threadIdx.x + t * kThreads;
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        v[t][k] = k0 + k < count && idx < 2 * d
                      ? __ldcg(base + static_cast<size_t>(k0 + k) * 2 * d +
                               idx)
                      : 0.f;
      }
    }
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
#pragma unroll
      for (int k = 0; k < kK; ++k) acc[t] += v[t][k];
    }
  }
}

// T threads a row (4 .. 32 lanes of a warp, or 64: two warps of half a row
// each), NV vectors of 8 columns a lane. kD: the width fixed at compile
// time (UMD-B's 768 and UMD-L's 1,024, whose offsets and masks then fold
// away as before the kernel took other widths), or 0 for `d_arg`. Lane q
// of a team's warp owns the vectors q, q + min(T, 32), ... of its slice
// of the row (the row, or the warp's half).
// work: (B, 2, d) f32 partials, then (groups, 2, d) group partials; row 0
// of each sums into dgamma, row 1 into dbeta. tickets: groups + 1
// counters, 0 when the kernel starts.
template <int T, int NV, int kD>
__global__ void __launch_bounds__(kThreads, 1)
ln_modulate_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ dy,
                       const float* __restrict__ mean,
                       const float* __restrict__ rstd,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       const __nv_bfloat16* __restrict__ scale,
                       int mod_stride, __nv_bfloat16* __restrict__ dx,
                       float* __restrict__ dgamma, float* __restrict__ dbeta,
                       float* __restrict__ dshift, float* __restrict__ dscale,
                       float* __restrict__ work,
                       unsigned int* __restrict__ tickets, int batch,
                       int seq_len, int d_arg) {
  const int d = kD ? kD : d_arg;
  constexpr int kLanes = T <= 32 ? T : 32;       // a team's lanes in a warp
  constexpr int kRows = T <= 32 ? 32 / T : 1;    // rows a warp holds a step
  constexpr int kTeams = kThreads / T;           // rows a CTA holds a step
  constexpr int kMaxCols = T <= 32 ? NV * T * 8 : NV * 2 * 32 * 8;
  constexpr int kPer = (2 * kMaxCols + kThreads - 1) / kThreads;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ unsigned int ticket;
  __shared__ float exchange[kWarps][2][2];  // T = 64: [warp][parity][s1, s2]
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = lane % kLanes;
  const int r = T <= 32 ? lane / T : 0;            // the warp's row r
  const int team0 = T <= 32 ? warp * kRows : warp / 2;  // its first team
  const int col0 = T <= 32 ? 0 : (warp & 1) * (d / 2);
  const int slice_cols = T <= 32 ? d : d / 2;
  const int nvec = slice_cols / 8;
  const int row_bytes = slice_cols * 2;            // a row's part in smem
  const int span = slice_bytes(T, d);              // x (or dy) of a step
  uint8_t* ring = smem + static_cast<size_t>(warp) * kStages * 2 * span;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + ring_bytes(T, d)) + warp * kStages;
  // Step j of the warp holds rows j * kTeams + team0 + r (r < kRows) of b.
  const int steps =
      seq_len > team0 ? (seq_len - team0 + kTeams - 1) / kTeams : 0;
  const size_t batch_row0 = static_cast<size_t>(b) * seq_len;

  auto issue = [&](int j) {  // lane 0: the warp's step j into its stage
    const int s = j % kStages;
    const int first = j * kTeams + team0;
    const int rows = T <= 32 ? min(kRows, seq_len - first) : 1;
    const uint32_t bytes = T <= 32 ? rows * d * 2 : d;
    const size_t off = (batch_row0 + first) * d + col0;
    sm90::mbar_arrive_expect_tx(&full[s], 2 * bytes);
    bulk_load(ring + s * 2 * span, x + off, bytes, &full[s]);
    bulk_load(ring + s * 2 * span + span, dy + off, bytes, &full[s]);
  };
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(&full[s], 1);
    sm90::fence_barrier_init();
    for (int j = 0; j < kStages && j < steps; ++j) issue(j);
  }
  __syncwarp();
  // mean and rstd of the warp's rows in the order (step, r), 32 at a time
  // and a chunk ahead (a load per row would expose its latency once a
  // row): lane i holds those of the warp's row 32 c + i of chunk c.
  auto stats = [&](int c, float& mu, float& rs) {
    const int m = c * 32 + lane;
    const int row = (m / kRows) * kTeams + team0 + m % kRows;
    if (row < seq_len) {
      mu = mean[batch_row0 + row];
      rs = rstd[batch_row0 + row];
    }
  };
  float mu_cur = 0.f, rs_cur = 0.f, mu_next = 0.f, rs_next = 0.f;
  stats(0, mu_cur, rs_cur);
  stats(1, mu_next, rs_next);

  float g[NV][8], ops[NV][8], acc_a[NV][8], acc_c[NV][8];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vec = q + i * kLanes;
    const int col = col0 + vec * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      g[i][e] = ops[i][e] = 1.f;
      acc_a[i][e] = acc_c[i][e] = 0.f;
    }
    if (vec < nvec) {
      const float4 g0 = *reinterpret_cast<const float4*>(gamma + col);
      const float4 g1 = *reinterpret_cast<const float4*>(gamma + col + 4);
      g[i][0] = g0.x; g[i][1] = g0.y; g[i][2] = g0.z; g[i][3] = g0.w;
      g[i][4] = g1.x; g[i][5] = g1.y; g[i][6] = g1.z; g[i][7] = g1.w;
      if (scale != nullptr) {
        load8(scale + static_cast<size_t>(b) * mod_stride + col, ops[i]);
#pragma unroll
        for (int e = 0; e < 8; ++e) ops[i][e] = 1.f + ops[i][e];
      }
    }
  }

  for (int j = 0; j < steps; ++j) {
    const int s = j % kStages;
    const int m = j * kRows + r;  // the lane's row in the warp's order
    const int row = j * kTeams + team0 + r;
    // A warp of one row a step (T >= 32) holds live rows only: `steps`
    // counts them.
    const bool live = kRows == 1 || row < seq_len;
    if (j > 0 && (j * kRows) % 32 == 0) {
      mu_cur = mu_next;
      rs_cur = rs_next;
      stats((j * kRows) / 32 + 1, mu_next, rs_next);
    }
    const float mu = __shfl_sync(0xffffffffu, mu_cur, m % 32);
    const float rs = __shfl_sync(0xffffffffu, rs_cur, m % 32);
    sm90::mbar_wait(&full[s], (j / kStages) & 1);
    const uint8_t* xs = ring + s * 2 * span + r * row_bytes;
    float xh[NV][8], dv[NV][8];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vec = q + i * kLanes;
      if (live && vec < nvec) {
        load8(xs + vec * 16, xh[i]);
        load8(xs + span + vec * 16, dv[i]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) xh[i][e] = dv[i][e] = 0.f;
      }
    }
    // Every lane has read the stage: refill it with step j + kStages.
    __syncwarp();
    if (lane == 0 && j + kStages < steps) {
      sm90::fence_proxy_async();
      issue(j + kStages);
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        xh[i][e] = (xh[i][e] - mu) * rs;
        acc_a[i][e] += dv[i][e];
        acc_c[i][e] += dv[i][e] * xh[i][e];
        dv[i][e] = dv[i][e] * ops[i][e] * g[i][e];  // dxhat
        s1 += dv[i][e];
        s2 += dv[i][e] * xh[i][e];
      }
    }
    s1 = team_sum<kLanes>(s1);
    s2 = team_sum<kLanes>(s2);
    if (T > 32) {  // the two warps' halves, added in warp order
      if (lane == 0) {
        exchange[warp][j & 1][0] = s1;
        exchange[warp][j & 1][1] = s2;
      }
      asm volatile("bar.sync %0, 64;\n" ::"r"(1 + warp / 2) : "memory");
      s1 = exchange[warp & ~1][j & 1][0] + exchange[warp | 1][j & 1][0];
      s2 = exchange[warp & ~1][j & 1][1] + exchange[warp | 1][j & 1][1];
    }
    if (!live) continue;
    const float m1 = s1 / d;
    const float m2 = s2 / d;
    __nv_bfloat16* dxr = dx + (batch_row0 + row) * d + col0;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vec = q + i * kLanes;
      if (vec >= nvec) continue;
      uint4 packed;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h[e] = __floats2bfloat162_rn(
            rs * (dv[i][2 * e] - m1 - xh[i][2 * e] * m2),
            rs * (dv[i][2 * e + 1] - m1 - xh[i][2 * e + 1] * m2));
      }
      *reinterpret_cast<uint4*>(dxr + vec * 8) = packed;
    }
  }

  // The teams' A and C through the drained ring ([team][2][d] f32), added
  // in team order.
  float* red = reinterpret_cast<float*>(smem);
  __syncthreads();
  const int team = team0 + r;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vec = q + i * kLanes;
    if (vec >= nvec) continue;
    float* ra = red + static_cast<size_t>(team * 2) * d + col0 + vec * 8;
    float* rc = ra + d;
#pragma unroll
    for (int e = 0; e < 8; e += 4) {
      *reinterpret_cast<float4*>(ra + e) = make_float4(
          acc_a[i][e], acc_a[i][e + 1], acc_a[i][e + 2], acc_a[i][e + 3]);
      *reinterpret_cast<float4*>(rc + e) = make_float4(
          acc_c[i][e], acc_c[i][e + 1], acc_c[i][e + 2], acc_c[i][e + 3]);
    }
  }
  __syncthreads();
  float* part = work + static_cast<size_t>(b) * 2 * d;
  for (int col = threadIdx.x; col < d; col += kThreads) {
    float a = 0.f, c = 0.f;
    for (int k = 0; k < kTeams; ++k) {
      a += red[static_cast<size_t>(k * 2) * d + col];
      c += red[static_cast<size_t>(k * 2 + 1) * d + col];
    }
    float op = 1.f;
    if (scale != nullptr) {
      op += __bfloat162float(scale[static_cast<size_t>(b) * mod_stride + col]);
      dshift[static_cast<size_t>(b) * d + col] = a;
      dscale[static_cast<size_t>(b) * d + col] = gamma[col] * c + beta[col] * a;
    }
    part[col] = op * c;
    part[d + col] = op * a;
  }

  const int group = b / kGroup;
  const int g0 = group * kGroup;
  const int in_group = min(kGroup, batch - g0);
  if (!last_to_arrive(tickets + group, in_group, &ticket)) return;
  float sums[kPer];
  sum_partials<kPer>(work + static_cast<size_t>(g0) * 2 * d, in_group, d,
                     sums);
  float* group_part = work + (static_cast<size_t>(batch) + group) * 2 * d;
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int idx = threadIdx.x + t * kThreads;
    if (idx < 2 * d) group_part[idx] = sums[t];
  }
  const int groups = num_groups(batch);
  if (!last_to_arrive(tickets + groups, groups, &ticket)) return;
  sum_partials<kPer>(work + static_cast<size_t>(batch) * 2 * d, groups, d,
                     sums);
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int idx = threadIdx.x + t * kThreads;
    if (idx < 2 * d) (idx < d ? dgamma : dbeta)[idx % d] = sums[t];
  }
}

template <int T, int NV, int kD = 0>
cudaError_t launch(const void* x, const void* dy, const void* mean,
                   const void* rstd, const void* gamma, const void* beta,
                   const void* scale, int mod_stride, void* dx, void* dgamma,
                   void* dbeta, void* dshift, void* dscale, void* work,
                   int batch, int seq_len, int d, cudaStream_t s) {
  const size_t smem = ring_bytes(T, d) + kWarps * kStages * 8;
  cudaError_t err = cudaFuncSetAttribute(
      ln_modulate_bwd_kernel<T, NV, kD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  unsigned int* tickets = reinterpret_cast<unsigned int*>(
      static_cast<float*>(work) +
      static_cast<size_t>(batch + num_groups(batch)) * 2 * d);
  err = cudaMemsetAsync(tickets, 0,
                        (num_groups(batch) + 1) * sizeof(unsigned int), s);
  if (err != cudaSuccess) return err;
  ln_modulate_bwd_kernel<T, NV, kD><<<batch, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(dy), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const float*>(gamma),
      static_cast<const float*>(beta),
      static_cast<const __nv_bfloat16*>(scale), mod_stride,
      static_cast<__nv_bfloat16*>(dx), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), static_cast<float*>(dshift),
      static_cast<float*>(dscale), static_cast<float*>(work), tickets, batch,
      seq_len, d);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Any dtype and width (the entry point `ln_modulate_bwd_any`).
// ---------------------------------------------------------------------------

using sv_vec::kAnyMaxWidth;
using sv_vec::kLaneValues;
using sv_vec::load_vec;
using sv_vec::store_vec;
using sv_vec::to_f32;

// out[idx] = the sum over k < count, in the order of k, of base[k * 2 d +
// idx], for every idx < 2 d (a loop over columns: any width).
__device__ __forceinline__ void sum_partials_any(const float* base,
                                                 int count, int d,
                                                 float* out) {
  for (int idx = threadIdx.x; idx < 2 * d; idx += kThreads) {
    float s = 0.f;
    for (int k = 0; k < count; ++k) {
      s += __ldcg(base + static_cast<size_t>(k) * 2 * d + idx);
    }
    out[idx] = s;
  }
}

// One CTA per batch row b; teams of kW warps take the rows k, k + kTeams,
// ... of b, lane q of a team owning the vectors q, q + 32 kW, ... of VEC
// columns (kNV at most, kNV * VEC = kLaneValues), the last masked. work
// and tickets as the kernel above. Dynamic shared memory: 2 d f32.
template <typename E, int VEC, int kW>
__global__ void __launch_bounds__(kThreads, 1)
ln_modulate_bwd_any_kernel(const E* __restrict__ x, const E* __restrict__ dy,
                           const float* __restrict__ mean,
                           const float* __restrict__ rstd,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta,
                           const E* __restrict__ scale, int mod_stride,
                           E* __restrict__ dx, float* __restrict__ dgamma,
                           float* __restrict__ dbeta,
                           float* __restrict__ dshift,
                           float* __restrict__ dscale,
                           float* __restrict__ work,
                           unsigned int* __restrict__ tickets, int batch,
                           int seq_len, int d) {
  constexpr int kTeam = kW * 32;
  constexpr int kTeams = kThreads / kTeam;
  constexpr int kNV = kLaneValues / VEC;
  extern __shared__ __align__(16) float red[];  // [2][d]: A, then C
  __shared__ float exchange[2][kWarps][2];      // [parity][warp][s1, s2]
  __shared__ unsigned int ticket;
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int q = threadIdx.x % kTeam;
  const int team = threadIdx.x / kTeam;
  const int nvec = d / VEC;
  const size_t batch_row0 = static_cast<size_t>(b) * seq_len;

  float g[kNV][VEC], ops[kNV][VEC], acc_a[kNV][VEC], acc_c[kNV][VEC];
#pragma unroll
  for (int i = 0; i < kNV; ++i) {
    const int vec = q + i * kTeam;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      g[i][e] = ops[i][e] = 1.f;
      acc_a[i][e] = acc_c[i][e] = 0.f;
    }
    if (vec < nvec) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) g[i][e] = gamma[vec * VEC + e];
      if (scale != nullptr) {
        load_vec<E, VEC>(scale + static_cast<size_t>(b) * mod_stride +
                             vec * VEC, ops[i]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) ops[i][e] = 1.f + ops[i][e];
      }
    }
  }

  const int steps = (seq_len + kTeams - 1) / kTeams;
  for (int j = 0; j < steps; ++j) {
    const int row = j * kTeams + team;
    const bool live = row < seq_len;
    const size_t off = (batch_row0 + (live ? row : 0)) * d;
    const float mu = live ? mean[batch_row0 + row] : 0.f;
    const float rs = live ? rstd[batch_row0 + row] : 0.f;
    float xh[kNV][VEC], dv[kNV][VEC];
#pragma unroll
    for (int i = 0; i < kNV; ++i) {
      const int vec = q + i * kTeam;
      if (live && vec < nvec) {
        load_vec<E, VEC>(x + off + vec * VEC, xh[i]);
        load_vec<E, VEC>(dy + off + vec * VEC, dv[i]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) xh[i][e] = dv[i][e] = 0.f;
      }
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kNV; ++i) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        xh[i][e] = (xh[i][e] - mu) * rs;
        acc_a[i][e] += dv[i][e];
        acc_c[i][e] += dv[i][e] * xh[i][e];
        dv[i][e] = dv[i][e] * ops[i][e] * g[i][e];  // dxhat
        s1 += dv[i][e];
        s2 += dv[i][e] * xh[i][e];
      }
    }
    s1 = team_sum<32>(s1);
    s2 = team_sum<32>(s2);
    if (kW > 1) {  // the team's warps' sums, added in warp order
      if (threadIdx.x % 32 == 0) {
        exchange[j & 1][warp][0] = s1;
        exchange[j & 1][warp][1] = s2;
      }
      __syncthreads();
      const int first = warp / kW * kW;
      s1 = s2 = 0.f;
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        s1 += exchange[j & 1][first + w][0];
        s2 += exchange[j & 1][first + w][1];
      }
    }
    if (!live) continue;
    const float m1 = s1 / d;
    const float m2 = s2 / d;
#pragma unroll
    for (int i = 0; i < kNV; ++i) {
      const int vec = q + i * kTeam;
      if (vec >= nvec) continue;
      float out[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        out[e] = rs * (dv[i][e] - m1 - xh[i][e] * m2);
      }
      store_vec<E, VEC>(dx + off + vec * VEC, out);
    }
  }

  // The teams' A and C, added in team order into red.
  for (int t = 0; t < kTeams; ++t) {
    __syncthreads();
    if (team != t) continue;
#pragma unroll
    for (int i = 0; i < kNV; ++i) {
      const int vec = q + i * kTeam;
      if (vec >= nvec) continue;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int col = vec * VEC + e;
        red[col] = t == 0 ? acc_a[i][e] : red[col] + acc_a[i][e];
        red[d + col] = t == 0 ? acc_c[i][e] : red[d + col] + acc_c[i][e];
      }
    }
  }
  __syncthreads();
  float* part = work + static_cast<size_t>(b) * 2 * d;
  for (int col = threadIdx.x; col < d; col += kThreads) {
    const float a = red[col], c = red[d + col];
    float op = 1.f;
    if (scale != nullptr) {
      op += to_f32(scale[static_cast<size_t>(b) * mod_stride + col]);
      dshift[static_cast<size_t>(b) * d + col] = a;
      dscale[static_cast<size_t>(b) * d + col] = gamma[col] * c + beta[col] * a;
    }
    part[col] = op * c;
    part[d + col] = op * a;
  }

  const int group = b / kGroup;
  const int g0 = group * kGroup;
  const int in_group = min(kGroup, batch - g0);
  if (!last_to_arrive(tickets + group, in_group, &ticket)) return;
  sum_partials_any(work + static_cast<size_t>(g0) * 2 * d, in_group, d,
                   work + (static_cast<size_t>(batch) + group) * 2 * d);
  const int groups = num_groups(batch);
  if (!last_to_arrive(tickets + groups, groups, &ticket)) return;
  // The group partials in group order: row 0 into dgamma, row 1 into
  // dbeta.
  for (int idx = threadIdx.x; idx < 2 * d; idx += kThreads) {
    float s = 0.f;
    for (int k = 0; k < groups; ++k) {
      s += __ldcg(work + (static_cast<size_t>(batch) + k) * 2 * d + idx);
    }
    (idx < d ? dgamma : dbeta)[idx % d] = s;
  }
}

template <typename E, int VEC, int kW>
cudaError_t launch_any(const void* x, const void* dy, const void* mean,
                       const void* rstd, const void* gamma, const void* beta,
                       const void* scale, int mod_stride, void* dx,
                       void* dgamma, void* dbeta, void* dshift, void* dscale,
                       void* work, int batch, int seq_len, int d,
                       cudaStream_t s) {
  const size_t smem = static_cast<size_t>(2) * d * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ln_modulate_bwd_any_kernel<E, VEC, kW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  unsigned int* tickets = reinterpret_cast<unsigned int*>(
      static_cast<float*>(work) +
      static_cast<size_t>(batch + num_groups(batch)) * 2 * d);
  err = cudaMemsetAsync(tickets, 0,
                        (num_groups(batch) + 1) * sizeof(unsigned int), s);
  if (err != cudaSuccess) return err;
  ln_modulate_bwd_any_kernel<E, VEC, kW><<<batch, kThreads, smem, s>>>(
      static_cast<const E*>(x), static_cast<const E*>(dy),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const E*>(scale), mod_stride, static_cast<E*>(dx),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta),
      static_cast<float*>(dshift), static_cast<float*>(dscale),
      static_cast<float*>(work), tickets, batch, seq_len, d);
  return cudaGetLastError();
}

template <typename E, int VEC>
cudaError_t launch_any_width(const void* x, const void* dy, const void* mean,
                             const void* rstd, const void* gamma,
                             const void* beta, const void* scale,
                             int mod_stride, void* dx, void* dgamma,
                             void* dbeta, void* dshift, void* dscale,
                             void* work, int batch, int seq_len, int d,
                             cudaStream_t s) {
  const int w = sv_vec::warps_a_row(d);
#define SV_LN_BWD_ANY_CASE(W)                                               \
  if (w == W) {                                                             \
    return launch_any<E, VEC, W>(x, dy, mean, rstd, gamma, beta, scale,     \
                                 mod_stride, dx, dgamma, dbeta, dshift,     \
                                 dscale, work, batch, seq_len, d, s);       \
  }
  SV_LN_BWD_ANY_CASE(1)
  SV_LN_BWD_ANY_CASE(2)
  SV_LN_BWD_ANY_CASE(4)
  SV_LN_BWD_ANY_CASE(8)
#undef SV_LN_BWD_ANY_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// Widest row the kernel takes; any multiple of 32 up to it.
extern "C" int ln_modulate_bwd_max_width() { return kMaxWidth; }

// Widest row `ln_modulate_bwd_any` takes; every width from 1 up to it.
extern "C" int ln_modulate_bwd_any_max_width() { return kAnyMaxWidth; }

// Number of 4-byte words the caller allocates in `work`: the (2, d) f32
// partials of the batch rows and of the groups, then the ticket counters.
extern "C" int ln_modulate_bwd_work_words(int batch, int seq_len, int d) {
  (void)seq_len;
  return (batch + num_groups(batch)) * 2 * d + num_groups(batch) + 1;
}

// x, dy, dx: (B*L, d) bf16, contiguous, 16-byte aligned. mean, rstd: (B*L,)
// f32. gamma, beta: (d,) f32. scale: (B, d) bf16 rows `mod_stride` elements
// apart, or null for a plain LayerNorm (then dshift, dscale are null too).
// dgamma, dbeta: (d,) f32; dshift, dscale: (B, d) f32. work: the partials
// and the tickets, see ln_modulate_bwd_work_words; the tickets are zeroed
// on `stream` before the kernel. A memset and one launch; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a width that is not a
// multiple of 32 in [32, 2048] or more than 65,536 batch rows.
extern "C" int ln_modulate_bwd(const void* x, const void* dy,
                               const void* mean, const void* rstd,
                               const void* gamma, const void* beta,
                               const void* scale, int mod_stride, void* dx,
                               void* dgamma, void* dbeta, void* dshift,
                               void* dscale, void* work, int batch,
                               int seq_len, int d, void* stream) {
  if (num_groups(batch) > kMaxGroups || d < 32 || d > kMaxWidth ||
      d % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int t = team_threads(d);
  const int lanes = t <= 32 ? t : 32;
  const int nv = ((t <= 32 ? d : d / 2) / 8 + lanes - 1) / lanes;
  if (d == 768 || d == 1024) {
    return static_cast<int>(
        d == 768 ? launch<32, 3, 768>(x, dy, mean, rstd, gamma, beta, scale,
                                      mod_stride, dx, dgamma, dbeta, dshift,
                                      dscale, work, batch, seq_len, d, s)
                 : launch<32, 4, 1024>(x, dy, mean, rstd, gamma, beta,
                                       scale, mod_stride, dx, dgamma, dbeta,
                                       dshift, dscale, work, batch, seq_len,
                                       d, s));
  }
#define SV_LN_BWD_CASE(T, NV)                                              \
  if (t == T && nv == NV) {                                                \
    return static_cast<int>(launch<T, NV>(                                 \
        x, dy, mean, rstd, gamma, beta, scale, mod_stride, dx, dgamma,     \
        dbeta, dshift, dscale, work, batch, seq_len, d, s));               \
  }
  SV_LN_BWD_CASE(4, 1)
  SV_LN_BWD_CASE(8, 1)
  SV_LN_BWD_CASE(8, 2)
  SV_LN_BWD_CASE(16, 1)
  SV_LN_BWD_CASE(16, 2)
  SV_LN_BWD_CASE(32, 1)
  SV_LN_BWD_CASE(32, 2)
  SV_LN_BWD_CASE(32, 3)
  SV_LN_BWD_CASE(32, 4)
  SV_LN_BWD_CASE(64, 3)
  SV_LN_BWD_CASE(64, 4)
#undef SV_LN_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// K2 at any width from 1 to 8,192, in bf16 (f32 == 0) or f32 (f32 == 1):
// the arguments of `ln_modulate_bwd`, with x, dy, dx and scale in that
// dtype, and vec: the elements of a load (1, 2, 4, or 8 in bf16), which
// divides d and mod_stride and to which every pointer of x's dtype is
// aligned. work: ln_modulate_bwd_work_words(batch, seq_len, d) words.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for another width
// or vector or more than 65,536 batch rows.
extern "C" int ln_modulate_bwd_any(const void* x, const void* dy,
                                   const void* mean, const void* rstd,
                                   const void* gamma, const void* beta,
                                   const void* scale, int mod_stride,
                                   void* dx, void* dgamma, void* dbeta,
                                   void* dshift, void* dscale, void* work,
                                   int batch, int seq_len, int d, int f32,
                                   int vec, void* stream) {
  if (num_groups(batch) > kMaxGroups || d < 1 || d > kAnyMaxWidth ||
      vec < 1 || d % vec != 0 || vec * (f32 ? 4 : 2) > 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SV_LN_BWD_ANY_VEC(E, V)                                             \
  if (vec == V) {                                                           \
    return static_cast<int>(launch_any_width<E, V>(                         \
        x, dy, mean, rstd, gamma, beta, scale, mod_stride, dx, dgamma,      \
        dbeta, dshift, dscale, work, batch, seq_len, d, s));                \
  }
  if (f32) {
    SV_LN_BWD_ANY_VEC(float, 1)
    SV_LN_BWD_ANY_VEC(float, 2)
    SV_LN_BWD_ANY_VEC(float, 4)
  } else {
    SV_LN_BWD_ANY_VEC(__nv_bfloat16, 1)
    SV_LN_BWD_ANY_VEC(__nv_bfloat16, 2)
    SV_LN_BWD_ANY_VEC(__nv_bfloat16, 4)
    SV_LN_BWD_ANY_VEC(__nv_bfloat16, 8)
  }
#undef SV_LN_BWD_ANY_VEC
  return static_cast<int>(cudaErrorInvalidValue);
}
