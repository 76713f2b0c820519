// A GEMM in plain f32 on the CUDA cores (SIMT FMA), with a bias or a bias
// and tanh-gelu epilogue: the products of K5's and K6's f32 instances
// (fused_mlp_f32.cu, fused_mha_f32.cu).
//
//   c_z (m, n) = epilogue(a (m, k) w_z (k, n) + bias_z (n,)),  z < num_w
//
// a's rows are `lda` floats apart, each w_z's n, each c_z's `ldc`; c_z
// starts `c_step` floats after c_{z-1} (K6's q, k and v side by side in
// one (m, 3 n) buffer: ldc = 3 n, c_step = n). Any m, n and k.
//
// Why SIMT: no wgmma instruction takes f32 x f32, and a TF32 product keeps
// about three decimal digits; the point of `dtype_mm="float32"` is f32.
// Bound on this card: operations, 2 m n k over 67 TFLOP/s of f32 FMA.
//
// Design: the register-blocked SGEMM. A CTA of 256 threads owns a 128 x 128
// tile of c; thread (ty, tx) of a 16 x 16 grid holds an 8 x 8 block of it,
// rows {4 ty + i, 64 + 4 ty + i} and columns {4 tx + j, 64 + 4 tx + j}
// (i, j < 4), so that its shared-memory reads are 16-byte vectors free of
// bank conflicts (a warp reads two rows of A's tile, broadcast, and 16
// distinct vectors of B's). k walks in chunks of 8, double-buffered in
// shared memory: the next chunk's loads go to registers while the current
// chunk's 8 x 64 FMAs a thread run, then to the other buffer, one barrier
// a chunk. A's chunk is stored transposed (k-major, rows padded to 132
// floats: the transposing stores hit 32 distinct banks). Loads are 16-byte
// vectors where the rows and the pointers allow it (`vec_*`, set by the
// host from the leading dimensions and the addresses) and scalars with
// bounds checks elsewhere: an f32 row of an odd width is not 16-byte
// aligned, and nothing is padded on the host. Past m, n and k the tiles
// read zeros and nothing is stored. Each output is one thread's sum over k
// in order, with no atomics, so two launches give the same bits.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace simt_f32 {

constexpr int kGemmTile = 128;    // rows and columns of c a CTA
constexpr int kGemmDepth = 8;     // k of a staged chunk
constexpr int kGemmThreads = 256;
constexpr int kGemmAStride = kGemmTile + 4;  // A's chunk, k-major, padded
constexpr int kGemmMaxW = 3;

enum class Epilogue { kBias, kBiasGeluTanh };

// The callers' tags: K5's launches (fused_mlp_f32.cu) and K6's
// (fused_mha_f32.cu) instantiate the kernel under names of their own, so
// that a profiler's trace tells them apart; the code is the same.
struct FusedMlp {};
struct FusedMha {};

// F.gelu(x, approximate="tanh") (flax's default gelu), in f32:
// 0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3))).
__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  constexpr float kKappa = 0.044715f;
  const float inner = kBeta * (x + kKappa * x * x * x);
  return 0.5f * x * (1.f + tanhf(inner));
}

struct GemmArgs {
  const float* a;
  const float* w[kGemmMaxW];
  const float* bias[kGemmMaxW];
  float* c;
  int lda, ldc, c_step;
  int m, n, k;
  bool vec_a, vec_w, vec_c;  // 16-byte vectors for A's, W's, C's rows
};

// Four consecutive floats of a row at p, those at or past `limit` columns
// (counted from `col`) zero; one 16-byte load where `vec` says the row and
// the pointer allow it and all four lie inside.
__device__ __forceinline__ void load4(const float* p, int col, int limit,
                                      bool vec, float (&out)[4]) {
  if (vec && col + 4 <= limit) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = col + j < limit ? p[j] : 0.f;
}

template <Epilogue kEpi, class Caller>
__global__ void __launch_bounds__(kGemmThreads, 2)
gemm_f32_kernel(const GemmArgs p) {
  __shared__ __align__(16) float as[2][kGemmDepth][kGemmAStride];
  __shared__ __align__(16) float bs[2][kGemmDepth][kGemmTile];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kGemmTile, n0 = blockIdx.x * kGemmTile;
  const float* w = p.w[blockIdx.z];
  const float* bias = p.bias[blockIdx.z];
  float* c = p.c + static_cast<size_t>(blockIdx.z) * p.c_step;

  // A chunk: thread -> row tid / 2, columns 4 (tid % 2) .. + 3; W chunk:
  // row tid / 32, columns 4 (tid % 32) .. + 3.
  const int a_row = tid / 2, a_col = (tid % 2) * 4;
  const int w_row = tid / 32, w_col = (tid % 32) * 4;
  const bool a_in = m0 + a_row < p.m;
  const float* a_src = p.a + static_cast<size_t>(a_in ? m0 + a_row : 0) *
                                 p.lda;
  float ra[4], rw[4];
  auto load = [&](int k0) {
    if (a_in) {
      load4(a_src + k0 + a_col, k0 + a_col, p.k, p.vec_a, ra);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) ra[j] = 0.f;
    }
    const int row = k0 + w_row;
    if (row < p.k) {
      load4(w + static_cast<size_t>(row) * p.n + n0 + w_col, n0 + w_col,
            p.n, p.vec_w, rw);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) rw[j] = 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 4; ++j) as[buf][a_col + j][a_row] = ra[j];
    *reinterpret_cast<float4*>(&bs[buf][w_row][w_col]) =
        make_float4(rw[0], rw[1], rw[2], rw[3]);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  const int chunks = (p.k + kGemmDepth - 1) / kGemmDepth;
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < chunks; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < chunks;
    if (more) load((t + 1) * kGemmDepth);
#pragma unroll
    for (int kk = 0; kk < kGemmDepth; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[cur][kk][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&as[cur][kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[cur][kk][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&bs[cur][kk][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    if (more) store(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (row >= p.m) continue;
    float* dst = c + static_cast<size_t>(row) * p.ldc;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = n0 + 64 * half + 4 * tx;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = col + j < p.n ? acc[i][4 * half + j] + bias[col + j] : 0.f;
        if (kEpi == Epilogue::kBiasGeluTanh) v[j] = gelu_tanh(v[j]);
      }
      if (p.vec_c && col + 4 <= p.n) {
        *reinterpret_cast<float4*>(dst + col) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (col + j < p.n) dst[col + j] = v[j];
        }
      }
    }
  }
}

inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// Launches the GEMM on `stream`: w and bias hold num_w (1 to 3) pointers.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a shape it does
// not take.
template <Epilogue kEpi, class Caller>
int gemm_f32(const float* a, int lda, const float* const* w,
             const float* const* bias, int num_w, float* c, int ldc,
             int c_step, int m, int n, int k, cudaStream_t stream) {
  const long long m_tiles = (static_cast<long long>(m) + kGemmTile - 1) /
                            kGemmTile;
  if (m <= 0 || n <= 0 || k <= 0 || num_w < 1 || num_w > kGemmMaxW ||
      lda < k || ldc < n || m_tiles > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GemmArgs p{};
  p.a = a;
  p.c = c;
  p.lda = lda;
  p.ldc = ldc;
  p.c_step = c_step;
  p.m = m;
  p.n = n;
  p.k = k;
  p.vec_a = aligned16(a) && lda % 4 == 0;
  p.vec_w = n % 4 == 0;
  p.vec_c = ldc % 4 == 0 && c_step % 4 == 0 && aligned16(c);
  for (int z = 0; z < num_w; ++z) {
    p.w[z] = w[z];
    p.bias[z] = bias[z];
    p.vec_w = p.vec_w && aligned16(w[z]);
  }
  const dim3 grid((n + kGemmTile - 1) / kGemmTile,
                  static_cast<unsigned>(m_tiles), num_w);
  gemm_f32_kernel<kEpi, Caller><<<grid, kGemmThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt_f32
