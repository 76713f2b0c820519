// Fused MLP forward on bf16 tensors: Dense, tanh-gelu, Dense in one kernel,
// for Hopper (sm_90a).
//
// Replaces: small_vision_tpu/ops/fused_block.py::_mlp_kernel (reached via
// _mlp_pallas / fused_mlp). Per row of x:
//   h = bf16(gelu_tanh(f32(x W1) + b1))        (f32 sums, f32 gelu)
//   y = bf16(f32(h W2) + b2)                   (f32 sums, one rounding)
// the TPU kernel's rounding points. The (rows, hidden) h never reaches
// device memory.
//
// Bound on this card: at the sampler's shape (16,640 rows, width 768,
// hidden 3,072) the 4*rows*768*3072 = 157 GFLOP take 0.159 ms at 989
// TFLOP/s, against 60.6 MB of x, y and weights (0.018 ms at 3.35 TB/s):
// the floor is the tensor cores. What bounds this design sooner is the L2:
// the TPU kernel keeps the 9.4 MB of weights resident in VMEM, a block
// here has 227 KB, so every row tile streams all the weights through
// shared memory again (260 tiles of 64 rows read 2.4 GB from the L2).
//
// Design: rows are independent, so B*L is flattened and one block of 8
// warps takes a tile of 64 rows (kMT = 4 m-tiles of 16). The x tile stays
// in shared memory for the whole block. The hidden dimension is walked in
// chunks of 64: three stages bring W1[:, chunk] in 256-row pieces and
// accumulate the (rows, 64) h
// chunk, whose bias, gelu and rounding happen in registers before it is
// parked in shared memory; three more stages bring W2[chunk, :] in
// 256-column pieces and add h W2 into the (rows, 768) f32 output
// accumulator, which lives in registers for the whole block: 64 * 768 / 256
// threads = 192 registers a thread, which is why the block is limited to
// one a multiprocessor and 255 registers a thread (ptxas: 255 used, 8 bytes
// spilled). A 32-row tile would need 96, but twice as many tiles would each
// stream all the weights from the L2, so the tile is the largest that
// fits.
// The stages form one sequence, double-buffered with cp.async: stage s + 1
// is in flight while stage s is multiplied. Weights are read row-major as
// they lie; B fragments come through ldmatrix.trans. Products are bf16
// mma.sync m16n8k16 with f32 accumulation. Not yet used: wgmma, TMA, a
// cluster sharing one weight stream between row tiles (a later change).

#include "mma.cuh"

namespace {

using namespace tiles;

constexpr int kD = 768;        // model width the kernel is built for
constexpr int kMT = 4;         // m-tiles of 16 rows per block
constexpr int kBM = 16 * kMT;  // rows per block
constexpr int kCG = 8 / kMT;   // warps side by side over the columns
constexpr int kN1 = 8 / kCG;   // h n-tiles per warp (of the chunk's 8)
constexpr int kN2 = 32 / kCG;  // output n-tiles per warp and stage
constexpr int kHC = 64;        // hidden columns per chunk
constexpr int kSub = 256;      // W1 rows / W2 columns per stage
constexpr int kSubs = kD / kSub;
constexpr int kThreads = 256;
constexpr int kXStride = kD + 8;
constexpr int kW2Stride = kSub + 8;
constexpr int kStageElems =
    kSub * kRowStride > kHC * kW2Stride ? kSub * kRowStride : kHC * kW2Stride;

constexpr size_t kSmemBytes =
    sizeof(__nv_bfloat16) *
    (static_cast<size_t>(kBM) * kXStride + kBM * kRowStride + 2 * kStageElems);

__device__ __forceinline__ float gelu_tanh(float x) {
  const float u = 0.7978845608028654f * (x + 0.044715f * (x * x * x));
  return x * (0.5f * (1.f + tanhf(u)));
}

__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w1,
                 const __nv_bfloat16* __restrict__ b1,
                 const __nv_bfloat16* __restrict__ w2,
                 const __nv_bfloat16* __restrict__ b2,
                 __nv_bfloat16* __restrict__ y, int rows, int hidden) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* h_s = x_s + kBM * kXStride;
  __nv_bfloat16* buf = h_s + kBM * kRowStride;  // two stages

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int mt = warp % kMT;  // this warp's m-tile
  const int cg = warp / kMT;  // and its column group
  const int row0 = blockIdx.x * kBM;
  const int n_stages = hidden / kHC * 2 * kSubs;

  auto load_stage = [&](int s) {
    __nv_bfloat16* dst = buf + (s & 1) * kStageElems;
    const int hc = s / (2 * kSubs);
    const int t = s - hc * 2 * kSubs;
    if (t < kSubs) {  // W1[t * 256 .. , hc * 64 ..]: 256 x 64
      cp_async_tile(dst, kRowStride,
                    w1 + static_cast<size_t>(t) * kSub * hidden + hc * kHC,
                    hidden, kSub, kHC, kSub, tid, kThreads);
    } else {          // W2[hc * 64 .., (t - 3) * 256 ..]: 64 x 256
      cp_async_tile(
          dst, kW2Stride,
          w2 + static_cast<size_t>(hc) * kHC * kD + (t - kSubs) * kSub, kD,
          kHC, kSub, kHC, tid, kThreads);
    }
    cp_async_commit();
  };

  // The x tile (rows past the end zero-filled) rides with stage 0.
  cp_async_tile(x_s, kXStride, x + static_cast<size_t>(row0) * kD, kD, kBM, kD,
                rows - row0, tid, kThreads);
  load_stage(0);

  float oacc[kSubs * kN2][4];
#pragma unroll
  for (int i = 0; i < kSubs * kN2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) oacc[i][j] = 0.f;
  }
  float hacc[kN1][4];

  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) {
      load_stage(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* w_s = buf + (s & 1) * kStageElems;
    const int hc = s / (2 * kSubs);
    const int t = s - hc * 2 * kSubs;
    if (t < kSubs) {
      // h chunk += x[:, t * 256 ..] W1 piece.
      if (t == 0) {
#pragma unroll
        for (int i = 0; i < kN1; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) hacc[i][j] = 0.f;
        }
      }
#pragma unroll 4
      for (int ks = 0; ks < kSub / 16; ++ks) {
        uint32_t a[4];
        load_a(a, x_s, kXStride, mt * 16, t * kSub + ks * 16, lane);
#pragma unroll
        for (int np = 0; np < kN1 / 2; ++np) {
          uint32_t b[4];
          load_b_pair_trans(b, w_s, kRowStride, ks * 16,
                            cg * (kN1 * 8) + np * 16, lane);
          mma_bf16_16816(hacc[np * 2], a, b[0], b[1]);
          mma_bf16_16816(hacc[np * 2 + 1], a, b[2], b[3]);
        }
      }
      if (t == kSubs - 1) {
        // Bias and gelu in f32, one rounding, parked for the second product.
#pragma unroll
        for (int nt = 0; nt < kN1; ++nt) {
          const int col = cg * (kN1 * 8) + nt * 8 + t4 * 2;
          const float bias0 = __bfloat162float(b1[hc * kHC + col]);
          const float bias1 = __bfloat162float(b1[hc * kHC + col + 1]);
          __nv_bfloat16* h_lo = h_s + (mt * 16 + g) * kRowStride + col;
          *reinterpret_cast<uint32_t*>(h_lo) =
              pack_bf16(gelu_tanh(hacc[nt][0] + bias0),
                        gelu_tanh(hacc[nt][1] + bias1));
          *reinterpret_cast<uint32_t*>(h_lo + 8 * kRowStride) =
              pack_bf16(gelu_tanh(hacc[nt][2] + bias0),
                        gelu_tanh(hacc[nt][3] + bias1));
        }
      }
    } else {
      // y[:, j * 256 ..] += h chunk times the W2 piece. The accumulator is
      // indexed by compile-time constants only, so it stays in registers.
      const int j = t - kSubs;
#pragma unroll
      for (int jj = 0; jj < kSubs; ++jj) {
        if (jj == j) {
#pragma unroll
          for (int ks = 0; ks < kHC / 16; ++ks) {
            uint32_t a[4];
            load_a(a, h_s, kRowStride, mt * 16, ks * 16, lane);
#pragma unroll
            for (int np = 0; np < kN2 / 2; ++np) {
              uint32_t b[4];
              load_b_pair_trans(b, w_s, kW2Stride, ks * 16,
                                cg * (kN2 * 8) + np * 16, lane);
              mma_bf16_16816(oacc[jj * kN2 + np * 2], a, b[0], b[1]);
              mma_bf16_16816(oacc[jj * kN2 + np * 2 + 1], a, b[2], b[3]);
            }
          }
        }
      }
    }
    __syncthreads();  // the stage's buffer (and h_s) may be written again
  }

  // y = bf16(acc + b2), rows past the end dropped.
  const int row_lo = row0 + mt * 16 + g;
#pragma unroll
  for (int jj = 0; jj < kSubs; ++jj) {
#pragma unroll
    for (int nt = 0; nt < kN2; ++nt) {
      const int col = jj * kSub + cg * (kN2 * 8) + nt * 8 + t4 * 2;
      const float bias0 = __bfloat162float(b2[col]);
      const float bias1 = __bfloat162float(b2[col + 1]);
      const float(&c)[4] = oacc[jj * kN2 + nt];
      if (row_lo < rows) {
        *reinterpret_cast<uint32_t*>(y + static_cast<size_t>(row_lo) * kD +
                                     col) =
            pack_bf16(c[0] + bias0, c[1] + bias1);
      }
      if (row_lo + 8 < rows) {
        *reinterpret_cast<uint32_t*>(y + static_cast<size_t>(row_lo + 8) * kD +
                                     col) =
            pack_bf16(c[2] + bias0, c[3] + bias1);
      }
    }
  }
}

}  // namespace

// The model width the kernel is built for, and the multiple the hidden
// width must be of.
extern "C" int fused_mlp_width() { return kD; }
extern "C" int fused_mlp_hidden_multiple() { return kHC; }

// x, y: (rows, 768) bf16; w1: (768, hidden), b1: (hidden,), w2: (hidden,
// 768), b2: (768,), all bf16, contiguous, 16-byte aligned; hidden a
// multiple of 64. Returns cudaGetLastError().
extern "C" int fused_mlp_fwd(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* y, int rows,
                             int hidden, void* stream) {
  if (hidden <= 0 || hidden % kHC != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_mlp_kernel<<<(rows + kBM - 1) / kBM, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(b1),
      static_cast<const __nv_bfloat16*>(w2),
      static_cast<const __nv_bfloat16*>(b2), static_cast<__nv_bfloat16*>(y),
      rows, hidden);
  return static_cast<int>(cudaGetLastError());
}
