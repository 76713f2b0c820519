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
// all in f32; dx is stored in bf16, the sums in f32.
//
// Bound on this card: memory. It reads x and dy and writes dx (6 bytes an
// element) against ~14 f32 operations an element: far under the card's
// operations-per-byte balance. The partial sums below add ~2*D*4 bytes per
// 32 rows, a few percent.
//
// Design. The TPU kernel carries dgamma/dbeta across its sequential grid in
// revisited output blocks; Hopper blocks run concurrently, so that cannot
// carry over, and atomics would make the sums depend on the order blocks
// finish. Instead:
//  1. ln_bwd_rows: one block per (32-row chunk, batch row b), so a block
//     never straddles two batch rows; one warp per row as in K1 (each lane
//     holds D/32 values, 16-byte loads). The row reductions are warp
//     shuffles. Each warp keeps, per column, A = sum dy and C = sum dy*xhat
//     over its rows in registers; the block adds its warps' sums in a fixed
//     order through shared memory and writes one (2, D) partial.
//  2. ln_bwd_finish: for each column and batch row, adds that row's chunk
//     partials in order, giving dshift = A and dscale = gamma*C + beta*A,
//     and sums (1 + scale[b]) * C and (1 + scale[b]) * A over b, again in a
//     fixed order, into dgamma and dbeta.
// No atomics, so two launches on the same inputs give the same bits. The
// sums are those of the TPU kernel regrouped (dscale = gamma*C + beta*A is
// sum(dy * (xhat*gamma + beta)) with gamma and beta factored out), so they
// agree with it to f32 rounding, not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kMaxD = 1024;
constexpr int kFinishCols = 32;
constexpr int kFinishRows = 16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

__host__ __device__ constexpr int num_chunks(int seq_len) {
  return (seq_len + kRowsPerBlock - 1) / kRowsPerBlock;
}

// D = NV * 256: lane `lane` owns columns (i * 32 + lane) * 8 .. + 7.
// partial: (B, chunks, 2, D) f32: [.., 0, :] = sum dy, [.., 1, :] =
// sum dy * xhat over the chunk's rows.
template <int NV>
__global__ void __launch_bounds__(kWarps * 32)
ln_bwd_rows(const __nv_bfloat16* __restrict__ x,
            const __nv_bfloat16* __restrict__ dy,
            const float* __restrict__ mean, const float* __restrict__ rstd,
            const float* __restrict__ gamma,
            const __nv_bfloat16* __restrict__ scale, int mod_stride,
            __nv_bfloat16* __restrict__ dx, float* __restrict__ partial,
            int seq_len) {
  constexpr int D = NV * 256;
  __shared__ float red[kWarps][2][D];
  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

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

  const int first = chunk * kRowsPerBlock + warp * kRowsPerWarp;
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int l = first + r;
    if (l >= seq_len) break;  // warp-uniform
    const size_t row = static_cast<size_t>(b) * seq_len + l;
    const float mu = mean[row];
    const float rs = rstd[row];
    float xh[NV][8], dv[NV][8];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int col = (i * 32 + lane) * 8;
      load8(x + row * D + col, xh[i]);
      load8(dy + row * D + col, dv[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        xh[i][j] = (xh[i][j] - mu) * rs;
        acc_a[i][j] += dv[i][j];
        acc_c[i][j] += dv[i][j] * xh[i][j];
        dv[i][j] = dv[i][j] * ops[i][j] * g[i][j];  // dxhat
        s1 += dv[i][j];
        s2 += dv[i][j] * xh[i][j];
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
      for (int j = 0; j < 4; ++j) {
        const int e = 2 * j;
        h[j] = __floats2bfloat162_rn(
            rs * (dv[i][e] - m1 - xh[i][e] * m2),
            rs * (dv[i][e + 1] - m1 - xh[i][e + 1] * m2));
      }
      *reinterpret_cast<uint4*>(dx + row * D + col) = packed;
    }
  }

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = (i * 32 + lane) * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[warp][0][col + j] = acc_a[i][j];
      red[warp][1][col + j] = acc_c[i][j];
    }
  }
  __syncthreads();
  float* out = partial +
               (static_cast<size_t>(b) * gridDim.x + chunk) * 2 * D;
  for (int idx = threadIdx.x; idx < 2 * D; idx += kWarps * 32) {
    const int k = idx / D;
    const int col = idx - k * D;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][k][col];
    out[idx] = s;
  }
}

// One thread per (column, batch-row group); see the header.
__global__ void __launch_bounds__(kFinishCols * kFinishRows)
ln_bwd_finish(const float* __restrict__ partial,
              const float* __restrict__ gamma,
              const float* __restrict__ beta,
              const __nv_bfloat16* __restrict__ scale, int mod_stride,
              float* __restrict__ dgamma, float* __restrict__ dbeta,
              float* __restrict__ dshift, float* __restrict__ dscale,
              int batch, int chunks, int d) {
  __shared__ float sg[kFinishRows][kFinishCols + 1];
  __shared__ float sb[kFinishRows][kFinishCols + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int col = blockIdx.x * kFinishCols + tx;
  const float gc = gamma[col];
  const float bc = beta[col];
  float ga = 0.f, ba = 0.f;
  for (int b = ty; b < batch; b += kFinishRows) {
    const float* p = partial + static_cast<size_t>(b) * chunks * 2 * d + col;
    float a = 0.f, c = 0.f;
    for (int ch = 0; ch < chunks; ++ch) {
      a += p[static_cast<size_t>(ch) * 2 * d];
      c += p[static_cast<size_t>(ch) * 2 * d + d];
    }
    float ops = 1.f;
    if (scale != nullptr) {
      ops += __bfloat162float(scale[static_cast<size_t>(b) * mod_stride +
                                    col]);
      dshift[static_cast<size_t>(b) * d + col] = a;
      dscale[static_cast<size_t>(b) * d + col] = gc * c + bc * a;
    }
    ga += ops * c;
    ba += ops * a;
  }
  sg[ty][tx] = ga;
  sb[ty][tx] = ba;
  __syncthreads();
  if (ty == 0) {
    float sga = 0.f, sba = 0.f;
#pragma unroll
    for (int r = 0; r < kFinishRows; ++r) {
      sga += sg[r][tx];
      sba += sb[r][tx];
    }
    dgamma[col] = sga;
    dbeta[col] = sba;
  }
}

}  // namespace

// Number of (2, d) f32 partials the caller allocates in `work` (times 2*d).
extern "C" int ln_modulate_bwd_partials(int batch, int seq_len) {
  return batch * num_chunks(seq_len);
}

// x, dy, dx: (B*L, d) bf16, contiguous. mean, rstd: (B*L,) f32. gamma,
// beta: (d,) f32. scale: (B, d) bf16 rows `mod_stride` elements apart, or
// null for a plain LayerNorm (then dshift, dscale are null too). dgamma,
// dbeta: (d,) f32; dshift, dscale: (B, d) f32. work: the partials, see
// ln_modulate_bwd_partials. Returns cudaGetLastError().
extern "C" int ln_modulate_bwd(const void* x, const void* dy,
                               const void* mean, const void* rstd,
                               const void* gamma, const void* beta,
                               const void* scale, int mod_stride, void* dx,
                               void* dgamma, void* dbeta, void* dshift,
                               void* dscale, void* work, int batch,
                               int seq_len, int d, void* stream) {
  if (d > kMaxD || d % kFinishCols != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* dyb = static_cast<const __nv_bfloat16*>(dy);
  const auto* mf = static_cast<const float*>(mean);
  const auto* rf = static_cast<const float*>(rstd);
  const auto* gf = static_cast<const float*>(gamma);
  const auto* bf = static_cast<const float*>(beta);
  const auto* sc = static_cast<const __nv_bfloat16*>(scale);
  auto* dxb = static_cast<__nv_bfloat16*>(dx);
  auto* part = static_cast<float*>(work);
  const int chunks = num_chunks(seq_len);
  const dim3 grid(chunks, batch);
  const dim3 block(kWarps * 32);
  switch (d) {  // The widths of UMD-B and UMD-L.
    case 768:
      ln_bwd_rows<3><<<grid, block, 0, s>>>(xb, dyb, mf, rf, gf, sc,
                                            mod_stride, dxb, part, seq_len);
      break;
    case 1024:
      ln_bwd_rows<4><<<grid, block, 0, s>>>(xb, dyb, mf, rf, gf, sc,
                                            mod_stride, dxb, part, seq_len);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_bwd_finish<<<d / kFinishCols, dim3(kFinishCols, kFinishRows), 0, s>>>(
      part, gf, bf, sc, mod_stride, static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), static_cast<float*>(dshift),
      static_cast<float*>(dscale), batch, chunks, d);
  return static_cast<int>(cudaGetLastError());
}
