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
// Design. One CTA per batch row b, eight warps. Warp w takes the rows w,
// w + 8, w + 16, ... of b; its rows of x and dy reach shared memory by bulk
// asynchronous copies (cp.async.bulk, completion counted on an mbarrier)
// through a ring of four rows, so three more rows (9 KB at D=768) are in
// flight while the warp reduces one: 72-96 KB an SM. Each lane holds D/32
// values of a row (16-byte loads from shared memory, conflict-free) and the
// mean and rstd of one of its warp's next 32 rows, loaded a chunk ahead;
// the row's two reductions are warp shuffles; dx leaves from registers in
// 16-byte stores. The lane keeps A and C of its columns in registers over
// its rows; the CTA adds its warps' in a fixed order through shared memory
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;   // rows of a warp in its ring
constexpr int kGroup = 16;   // batch rows of a first-level sum
constexpr int kMaxGroups = 4096;

__host__ __device__ constexpr int num_groups(int batch) {
  return (batch + kGroup - 1) / kGroup;
}

__host__ __device__ constexpr size_t ring_bytes(int d) {
  return static_cast<size_t>(kWarps) * kStages * 2 * d * 2;
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
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
// base[k * 2 D + threadIdx.x + t * kThreads]: 16 rows' loads are issued
// before their adds (the partials were written by other CTAs, so they are
// read from L2).
template <int D>
__device__ __forceinline__ void sum_partials(const float* base, int count,
                                             float (&acc)[2 * D / kThreads]) {
  constexpr int kPer = 2 * D / kThreads;
#pragma unroll
  for (int t = 0; t < kPer; ++t) acc[t] = 0.f;
  for (int k0 = 0; k0 < count; k0 += kGroup) {
    float v[kPer][kGroup];
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        v[t][k] = k0 + k < count
                      ? __ldcg(base + static_cast<size_t>(k0 + k) * 2 * D +
                               threadIdx.x + t * kThreads)
                      : 0.f;
      }
    }
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) acc[t] += v[t][k];
    }
  }
}

// D = NV * 256: lane `lane` owns columns (i * 32 + lane) * 8 .. + 7.
// work: (B, 2, D) f32 partials, then (groups, 2, D) group partials; row 0
// of each sums into dgamma, row 1 into dbeta. tickets: groups + 1
// counters, 0 when the kernel starts.
template <int NV>
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
                       int seq_len) {
  constexpr int D = NV * 256;
  constexpr int kRowBytes = D * 2;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ unsigned int ticket;
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // Stage s of warp w: its x row, then its dy row; one barrier a stage.
  uint8_t* ring = smem + static_cast<size_t>(warp) * kStages * 2 * kRowBytes;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + ring_bytes(D)) + warp * kStages;
  const size_t first_row = static_cast<size_t>(b) * seq_len + warp;
  const int rows = (seq_len - warp + kWarps - 1) / kWarps;

  auto issue = [&](int j) {  // lane 0: the warp's row j into its stage
    const int s = j % kStages;
    const size_t row = first_row + static_cast<size_t>(j) * kWarps;
    sm90::mbar_arrive_expect_tx(&full[s], 2 * kRowBytes);
    bulk_load(ring + s * 2 * kRowBytes, x + row * D, kRowBytes, &full[s]);
    bulk_load(ring + s * 2 * kRowBytes + kRowBytes, dy + row * D, kRowBytes,
              &full[s]);
  };
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(&full[s], 1);
    sm90::fence_barrier_init();
    for (int j = 0; j < kStages && j < rows; ++j) issue(j);
  }
  __syncwarp();
  // mean and rstd of the warp's rows, 32 rows at a time and a chunk ahead
  // (a load per row would expose its latency once a row): lane i holds
  // those of row 32 c + i of chunk c.
  auto stats = [&](int c, float& mu, float& rs) {
    const int j = c * 32 + lane;
    if (j < rows) {
      const size_t row = first_row + static_cast<size_t>(j) * kWarps;
      mu = mean[row];
      rs = rstd[row];
    }
  };
  float mu_cur = 0.f, rs_cur = 0.f, mu_next = 0.f, rs_next = 0.f;
  stats(0, mu_cur, rs_cur);
  stats(1, mu_next, rs_next);

  float g[NV][8], ops[NV][8], acc_a[NV][8], acc_c[NV][8];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = (i * 32 + lane) * 8;
    const float4 g0 = *reinterpret_cast<const float4*>(gamma + col);
    const float4 g1 = *reinterpret_cast<const float4*>(gamma + col + 4);
    g[i][0] = g0.x; g[i][1] = g0.y; g[i][2] = g0.z; g[i][3] = g0.w;
    g[i][4] = g1.x; g[i][5] = g1.y; g[i][6] = g1.z; g[i][7] = g1.w;
    if (scale != nullptr) {
      load8(scale + static_cast<size_t>(b) * mod_stride + col, ops[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) ops[i][j] = 1.f + ops[i][j];
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) ops[i][j] = 1.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) acc_a[i][j] = acc_c[i][j] = 0.f;
  }

  for (int j = 0; j < rows; ++j) {
    const int s = j % kStages;
    const size_t row = first_row + static_cast<size_t>(j) * kWarps;
    if (j > 0 && j % 32 == 0) {
      mu_cur = mu_next;
      rs_cur = rs_next;
      stats(j / 32 + 1, mu_next, rs_next);
    }
    const float mu = __shfl_sync(0xffffffffu, mu_cur, j % 32);
    const float rs = __shfl_sync(0xffffffffu, rs_cur, j % 32);
    sm90::mbar_wait(&full[s], (j / kStages) & 1);
    const uint8_t* xs = ring + s * 2 * kRowBytes;
    float xh[NV][8], dv[NV][8];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      load8(xs + (i * 32 + lane) * 16, xh[i]);
      load8(xs + kRowBytes + (i * 32 + lane) * 16, dv[i]);
    }
    // Every lane has read the stage: refill it with row j + kStages.
    __syncwarp();
    if (lane == 0 && j + kStages < rows) {
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
    const float m1 = warp_sum(s1) / D;
    const float m2 = warp_sum(s2) / D;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int col = (i * 32 + lane) * 8;
      uint4 packed;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h[e] = __floats2bfloat162_rn(
            rs * (dv[i][2 * e] - m1 - xh[i][2 * e] * m2),
            rs * (dv[i][2 * e + 1] - m1 - xh[i][2 * e + 1] * m2));
      }
      *reinterpret_cast<uint4*>(dx + row * D + col) = packed;
    }
  }

  // The warps' A and C through the drained ring ([warp][2][D] f32), added
  // in warp order.
  float* red = reinterpret_cast<float*>(smem);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = (i * 32 + lane) * 8;
    float* ra = red + (warp * 2) * D + col;
    float* rc = ra + D;
#pragma unroll
    for (int e = 0; e < 8; e += 4) {
      *reinterpret_cast<float4*>(ra + e) = make_float4(
          acc_a[i][e], acc_a[i][e + 1], acc_a[i][e + 2], acc_a[i][e + 3]);
      *reinterpret_cast<float4*>(rc + e) = make_float4(
          acc_c[i][e], acc_c[i][e + 1], acc_c[i][e + 2], acc_c[i][e + 3]);
    }
  }
  __syncthreads();
  float* part = work + static_cast<size_t>(b) * 2 * D;
  for (int col = threadIdx.x; col < D; col += kThreads) {
    float a = 0.f, c = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += red[(w * 2) * D + col];
      c += red[(w * 2 + 1) * D + col];
    }
    float op = 1.f;
    if (scale != nullptr) {
      op += __bfloat162float(scale[static_cast<size_t>(b) * mod_stride + col]);
      dshift[static_cast<size_t>(b) * D + col] = a;
      dscale[static_cast<size_t>(b) * D + col] = gamma[col] * c + beta[col] * a;
    }
    part[col] = op * c;
    part[D + col] = op * a;
  }

  const int group = b / kGroup;
  const int g0 = group * kGroup;
  const int in_group = min(kGroup, batch - g0);
  if (!last_to_arrive(tickets + group, in_group, &ticket)) return;
  constexpr int kPer = 2 * D / kThreads;
  float sums[kPer];
  sum_partials<D>(work + static_cast<size_t>(g0) * 2 * D, in_group, sums);
  float* group_part = work + (static_cast<size_t>(batch) + group) * 2 * D;
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    group_part[threadIdx.x + t * kThreads] = sums[t];
  }
  const int groups = num_groups(batch);
  if (!last_to_arrive(tickets + groups, groups, &ticket)) return;
  sum_partials<D>(work + static_cast<size_t>(batch) * 2 * D, groups, sums);
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int idx = threadIdx.x + t * kThreads;
    (idx < D ? dgamma : dbeta)[idx % D] = sums[t];
  }
}

template <int NV>
cudaError_t launch(const void* x, const void* dy, const void* mean,
                   const void* rstd, const void* gamma, const void* beta,
                   const void* scale, int mod_stride, void* dx, void* dgamma,
                   void* dbeta, void* dshift, void* dscale, void* work,
                   int batch, int seq_len, cudaStream_t s) {
  constexpr int D = NV * 256;
  const size_t smem = ring_bytes(D) + kWarps * kStages * 8;
  cudaError_t err = cudaFuncSetAttribute(
      ln_modulate_bwd_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  unsigned int* tickets = reinterpret_cast<unsigned int*>(
      static_cast<float*>(work) +
      static_cast<size_t>(batch + num_groups(batch)) * 2 * D);
  err = cudaMemsetAsync(tickets, 0,
                        (num_groups(batch) + 1) * sizeof(unsigned int), s);
  if (err != cudaSuccess) return err;
  ln_modulate_bwd_kernel<NV><<<batch, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(dy), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const float*>(gamma),
      static_cast<const float*>(beta),
      static_cast<const __nv_bfloat16*>(scale), mod_stride,
      static_cast<__nv_bfloat16*>(dx), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), static_cast<float*>(dshift),
      static_cast<float*>(dscale), static_cast<float*>(work), tickets, batch,
      seq_len);
  return cudaGetLastError();
}

}  // namespace

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
// cudaGetLastError(), or cudaErrorInvalidValue for a width other than 768
// and 1,024 or more than 65,536 batch rows.
extern "C" int ln_modulate_bwd(const void* x, const void* dy,
                               const void* mean, const void* rstd,
                               const void* gamma, const void* beta,
                               const void* scale, int mod_stride, void* dx,
                               void* dgamma, void* dbeta, void* dshift,
                               void* dscale, void* work, int batch,
                               int seq_len, int d, void* stream) {
  if (num_groups(batch) > kMaxGroups) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {  // The widths of UMD-B and UMD-L.
    case 768:
      return static_cast<int>(launch<3>(x, dy, mean, rstd, gamma, beta, scale,
                                        mod_stride, dx, dgamma, dbeta, dshift,
                                        dscale, work, batch, seq_len, s));
    case 1024:
      return static_cast<int>(launch<4>(x, dy, mean, rstd, gamma, beta, scale,
                                        mod_stride, dx, dgamma, dbeta, dshift,
                                        dscale, work, batch, seq_len, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
