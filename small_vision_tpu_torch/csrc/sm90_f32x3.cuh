// What the f32 attention kernels for Hopper (sm_90a) share: the softmax
// policies and the limits of every f32 attention kernel, and the 3xTF32
// arithmetic and staging of the forward (sm90_f32x3_attention.cuh: K3's
// and K7's f32 instances, whose scores take a finer split of their own)
// and the backwards (sm90_f32x3_attention_bwd.cuh: K4's and K8's). K6's
// f32 attention stage (simt_f32_attention.cuh) takes the same policy and
// limits.
//
// 3xTF32. Each operand x is split into hi = tf32(x) (10 mantissa bits, to
// nearest, ties away from zero, as cvt.rna.tf32.f32 rounds) and lo =
// tf32(x - hi), and a product is a_lo b_hi + a_hi b_lo + a_hi b_hi (the
// small terms first), three wgmma.m64nNk8.f32.tf32.tf32 into one f32
// accumulator: hi + lo is x to within 2^-22 of it (f32's unit roundoff is
// 2^-24) and the dropped a_lo b_lo is 2^-22 of the product, so a sum is
// within a few f32 roundings of the exact one (one TF32 pass keeps about
// three decimal digits).
// The tensor core adds into its accumulator with its own rounding, whose
// error grows with the number of products it adds (a score summed over D =
// 768 in one accumulator came out further from float64 than f32 FMA's),
// so no accumulator runs long: the kernels sum each 32-column chunk of D,
// and each key or query chunk of the products over L, in a fresh
// accumulator and add it to the running f32 sum with an ordinary add.
//
// Tiles. A split tile is a hi tile of up to 64 rows of 32 f32 (128 bytes a
// row, the 128-byte swizzle of sm90.cuh's descriptors: 16-byte chunk j of
// row r at chunk j ^ (r % 8); a k8 step is 32 bytes, as bf16's k16) and,
// kSub further, its lo tile. TF32 wgmma reads K-major operands only.
// Operands arrive as raw f32 rows by cp.async (16-byte copies where D, the
// row stride and the pointers allow them, 4-byte ones elsewhere;
// zero-filled past L and D, so D rounds up to a k8 step with no padded
// copy), and the threads split them. TMA is not used: it copies bytes and
// cannot split them, and its 16-byte strides refuse rows of H D floats
// that are not a multiple of 4, which these kernels take.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90.cuh"

namespace f32x3 {

constexpr int kMaxLen = 4096;
constexpr int kMaxHeadDim = 2048;
constexpr float kClamp = 80.f;

constexpr int kRows = 64;       // a CTA's rows: queries, or keys (dK, dV)
constexpr int kChunkCols = 32;  // f32 columns of a tile row (128 bytes)
constexpr int kCols = 64;       // output columns of a CTA
constexpr int kMaxN = 64;       // widest key or query chunk
constexpr int kThreads = 128;   // one warpgroup
constexpr int kSub = kRows * 128;  // a hi or lo tile, 8 KB

// The softmax policies: e of a score s, or of a score that the forward
// holds as a pair hi + lo (sm90_f32x3_attention.cuh), whose scaled value
// is `scaled(hi, lo, scale2)`.
__device__ __forceinline__ float scaled(float hi, float lo, float scale2) {
  return fmaf(hi, scale2, lo * scale2);
}

// The clamped exp2 softmax of the packed TPU kernels (K3, K4): no max.
struct ClampExp2 {
  static constexpr bool kShift = false;
  static __device__ __forceinline__ float e(float s, float scale2, float) {
    return exp2f(fminf(fmaxf(s * scale2, -kClamp), kClamp));
  }
  static __device__ __forceinline__ float e(float hi, float lo, float scale2,
                                            float) {
    return exp2f(fminf(fmaxf(scaled(hi, lo, scale2), -kClamp), kClamp));
  }
};

// The max-shift softmax (K6, K7, K8): exp2 of the log2(e)-scaled scores
// less their row max m; of a pair, t - m as fma(hi, scale2, -m) + lo
// scale2, one rounding of a number near 0 where t nears m.
struct MaxShift {
  static constexpr bool kShift = true;
  static __device__ __forceinline__ float e(float s, float scale2,
                                            float m) {
    return exp2f(s * scale2 - m);
  }
  static __device__ __forceinline__ float e(float hi, float lo, float scale2,
                                            float m) {
    return exp2f(fmaf(hi, scale2, -m) + lo * scale2);
  }
};

// The shapes every f32 attention kernel takes: L up to 4,096, head dims 1
// to 2,048, the grid's y (heads times 64-column chunks) and z in range.
inline bool attn_takes(int batch, int len, int heads, int d) {
  return batch >= 1 && batch <= 65535 && len >= 1 && len <= kMaxLen &&
         heads >= 1 && d >= 1 && d <= kMaxHeadDim &&
         static_cast<long long>(heads) * ((d + kCols - 1) / kCols) <= 65535;
}

// The key (query) chunk: the length split into as few chunks of at most
// kMaxN as it takes, evened out, rounded up to a multiple of 8 (wgmma's N
// takes any multiple of 8): 40 at L = 68, 56 at 164, 257 and 260, so a
// short length computes few rows past L.
inline int chunk_width(int len) {
  const int chunks = (len + kMaxN - 1) / kMaxN;
  return ((len + chunks - 1) / chunks + 7) / 8 * 8;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ---- tf32 -------------------------------------------------------------------

// x = hi + lo: hi is x rounded to tf32 (10 mantissa bits, to nearest, ties
// away from zero, as cvt.rna.tf32.f32 rounds) and lo the rest, x - hi
// (exact in f32), rounded the same way. Integer and f32 adds at the full
// rate; cvt.rna runs on the conversion pipe, 16 a clock an SM.
__device__ __forceinline__ float rna_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - hi);
}

// Byte offset of element (r, c) of a tile of 32-float rows, 128-byte
// swizzled: 16-byte chunk j of row r at chunk j ^ (r % 8).
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * 128 + (((c >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// ---- wgmma ------------------------------------------------------------------

// D (64 x N, f32) [+]= A B^T over one k8 step, A (64 x 8) and B (N x 8)
// tf32 from K-major shared tiles; scale_d 0 overwrites D.
template <int N>
__device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t da,
                                    uint64_t db, int scale_d);

#define F32X3_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F32X3_MMA(N, A, B, P, REGS, ...)                                  \
  template <>                                                             \
  __device__ __forceinline__ void mma<N>(float (&d)[N / 2], uint64_t da,  \
                                         uint64_t db, int scale_d) {      \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"           \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 " \
                 REGS ", " A ", " B ", p, 1, 1;\n}\n"                      \
                 : __VA_ARGS__                                            \
                 : "l"(da), "l"(db), "r"(scale_d));                       \
  }

F32X3_MMA(8, "%4", "%5", "%6",
    "{%0, %1, %2, %3}",
    F32X3_D4(0))
F32X3_MMA(16, "%8", "%9", "%10",
    "{%0, %1, %2, %3, %4, %5, %6, %7}",
    F32X3_D4(0), F32X3_D4(4))
F32X3_MMA(24, "%12", "%13", "%14",
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}",
    F32X3_D4(0), F32X3_D4(4), F32X3_D4(8))
F32X3_MMA(32, "%16", "%17", "%18",
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
    "%13, %14, %15}",
    F32X3_D4(0), F32X3_D4(4), F32X3_D4(8), F32X3_D4(12))
F32X3_MMA(40, "%20", "%21", "%22",
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
    "%13, %14, %15, %16, %17, %18, %19}",
    F32X3_D4(0), F32X3_D4(4), F32X3_D4(8), F32X3_D4(12), F32X3_D4(16))
F32X3_MMA(48, "%24", "%25", "%26",
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
    "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}",
    F32X3_D4(0), F32X3_D4(4), F32X3_D4(8), F32X3_D4(12), F32X3_D4(16),
    F32X3_D4(20))
F32X3_MMA(56, "%28", "%29", "%30",
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
    "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
    "%24, %25, %26, %27}",
    F32X3_D4(0), F32X3_D4(4), F32X3_D4(8), F32X3_D4(12), F32X3_D4(16),
    F32X3_D4(20), F32X3_D4(24))
F32X3_MMA(64, "%32", "%33", "%34",
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
    "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
    "%24, %25, %26, %27, %28, %29, %30, %31}",
    F32X3_D4(0), F32X3_D4(4), F32X3_D4(8), F32X3_D4(12), F32X3_D4(16),
    F32X3_D4(20), F32X3_D4(24), F32X3_D4(28))

// D (64 x 64, f32) [+]= A B^T over one k8 step, A (64 x 8 tf32) from
// registers in the m16n8k8 fragment layout (this thread: rows 16 w + g and
// + 8, columns t4 and t4 + 4, as a[0] (g, t4), a[1] (g + 8, t4), a[2] (g,
// t4 + 4), a[3] (g + 8, t4 + 4)), B (64 x 8) from a K-major shared tile.
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
               "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
               "%24, %25, %26, %27, %28, %29, %30, %31}, "
               "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
               : F32X3_D4(0), F32X3_D4(4), F32X3_D4(8), F32X3_D4(12),
                 F32X3_D4(16), F32X3_D4(20), F32X3_D4(24), F32X3_D4(28)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                 "r"(scale_d));
}

#undef F32X3_MMA
#undef F32X3_D4

// One k8 step in three passes, the small terms first; `first` overwrites D.
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N / 2], uint64_t a_hi,
                                     uint64_t a_lo, uint64_t b_hi,
                                     uint64_t b_lo, bool first) {
  mma<N>(d, a_lo, b_hi, first ? 0 : 1);
  mma<N>(d, a_hi, b_lo, 1);
  mma<N>(d, a_hi, b_hi, 1);
}

// acc = A B^T over one 32-column chunk: A the split tile of 64 rows at a,
// B that of kN rows at b.
template <int kN>
__device__ __forceinline__ void chunk_product(float (&acc)[kN / 2],
                                              const uint8_t* a,
                                              const uint8_t* b) {
  const uint64_t ah = sm90::desc_k_major(a), al = sm90::desc_k_major(a + kSub);
  const uint64_t bh = sm90::desc_k_major(b), bl = sm90::desc_k_major(b + kSub);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint64_t s = ks * sm90::kKMajorStep;
    mma3<kN>(acc, ah + s, al + s, bh + s, bl + s, ks == 0);
  }
}

// ---- staging ------------------------------------------------------------------

// 16 (or 4) bytes from global src to shared dst, zero-filled where `valid`
// fails (nothing is read then; src stays a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Issues the copies of rows [row0, row0 + kR) x columns [col0, col0 +
// kW) of a head (rows `stride` floats apart; zeros past L and D), element
// (r, c) of them to dst(r, c), a group of 4 columns (c a multiple of 4)
// at dst(r, c) .. + 3. `vec`: 16-byte copies (D, the stride and the rows'
// starts are multiples of 4 floats, 16-byte aligned, so a group is whole
// or past D); else one float a copy.
template <int kR, int kW, class Dst>
__device__ __forceinline__ void copy_rows(Dst&& dst, const float* src,
                                          int row0, int len, int stride,
                                          int col0, int d, bool vec) {
  constexpr int kGroups = kR * kW / 4;
#pragma unroll
  for (int it = 0; it < (kGroups + kThreads - 1) / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    if (kGroups % kThreads != 0 && idx >= kGroups) break;
    const int r = idx / (kW / 4), c = 4 * (idx % (kW / 4));
    const int row = row0 + r, col = col0 + c;
    const float* p = src + static_cast<size_t>(row) * stride + col;
    float* q = dst(r, c);
    if (vec) {
      const bool ok = row < len && col < d;
      cp_async16(q, ok ? p : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = row < len && col + e < d;
        cp_async4(q + e, ok ? p + e : src, ok);
      }
    }
  }
}

// Rows row0 + 16 w + g (times f[0]) and + 8 (times f[1]) of a warpgroup's
// 64 x 64 accumulator into columns [col0, col0 + 64) of a head, nothing
// past L or D. `vec`: D, the stride and out even, 8-byte stores.
__device__ __forceinline__ void store_out(float* out, int stride, int row0,
                                          int len, int col0, int d,
                                          const float (&acc)[32],
                                          const float (&f)[2], bool vec) {
  const int lane = threadIdx.x % 32;
  const int r0 = row0 + 16 * (threadIdx.x / 32) + lane / 4;
  const int t4 = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= len) continue;
    float* o = out + static_cast<size_t>(row) * stride;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = col0 + 8 * n + 2 * t4;
      const float x0 = acc[4 * n + 2 * h] * f[h];
      const float x1 = acc[4 * n + 2 * h + 1] * f[h];
      if (vec && col < d) {
        *reinterpret_cast<float2*>(o + col) = make_float2(x0, x1);
      } else {
        if (col < d) o[col] = x0;
        if (col + 1 < d) o[col + 1] = x1;
      }
    }
  }
}

// ---- host -------------------------------------------------------------------

template <class Kernel, class Args>
cudaError_t launch_one(Kernel kernel, dim3 grid, size_t smem, const Args& a,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace f32x3
