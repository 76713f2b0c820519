// Bidirectional attention on packed (B, L, H*D) bf16 tensors, forward, for
// Hopper (sm_90a), at any head dim D that is a multiple of 8 up to 128.
//
// Replaces: small_vision_tpu/ops/attention.py::_attn_kernel_packed (reached
// via pallas_attention_packed / fused_attention_packed). Per (batch, head):
//   S = (Q K^T) * scale * log2(e)                        (f32)
//   e = exp2(clamp(S, -80, 80)) * keymask                (f32; no max shift)
//   s = rowsum(e)                                        (f32, unrounded e)
//   O = (bf16(e) V) / s                                  (f32 sums, bf16 out)
// the same clamp stabiliser and the same rounding of e before the PV product
// as the TPU kernel. Keys past L get e = 0; query rows past L are not stored.
//
// Bound on this card: at the sampler's shapes (B=64, H=12, L=260, D=64)
// the 4*B*L*H*D*2 bytes of q, k, v and o (~102 MB, ~30 us at 3.35 TB/s)
// outweigh the 4*B*H*L^2*D flops (~13 GFLOP, ~13 us at 989 TFLOP/s), so
// the floor is memory; the exp2 of every score (B*H*L^2 ~ 52 M) is the
// next limit.
//
// Design: the (L, L) scores never leave the SM. One CTA takes one (batch,
// head) and reads its K and V once: its first thread starts TMA copies of
// them in 64-key blocks (a 3-D tensor map over (H*64, L, B), box (64, 64,
// 1), the 128-byte swizzle; rows past L arrive as zeros), each block on its
// own mbarrier, and they stay resident (80 KB at L=260; 13 blocks, L <= 832,
// fit the 227 KB a block can use). Its warpgroups (two, or one for short
// heads; see the grid below) walk the head's 64-row query tiles
// (warpgroup w of two takes tiles w, w + 2, ...), each from its own Q
// buffer, which its first thread refills by TMA once the tile's products
// are done, during the tile's epilogue. For a key block j a warpgroup runs
// S = Q K_j^T on wgmma (m64n64k16, both operands K-major from shared
// memory) as soon as block j has landed, the clamped exp2 and the mask,
// adds the unrounded f32 e to its row sums, packs e to bf16 (the
// accumulator's layout is wgmma's A-register layout) and runs O += e V_j on
// wgmma with V_j row-major through the transpose-B bit. The clamp replaces
// the max shift, so no online rescaling is needed and block j + 1's S
// product is issued together with block j's PV product, one commit and one
// wait for both. No warp is set aside as a producer: the copies are issued
// once (K, V) or once a tile (Q), and a ninth warp would cost the
// consumers registers (see below).
//
// What this does about the old kernel's costs: V is no longer staged
// transposed with 2-byte stores (8-way bank conflicts), and K and V are
// read once per head, not once per query tile (5 times at L=260). The first
// S product starts when Q and the first key block have landed, not after a
// synchronous prologue over the whole head. Shared memory at L=272 is
// 5 x 16 KB of K and V plus two 8 KB Q tiles (97 KB), so two CTAs (four
// warpgroups) share an SM.
//
// Registers: two 256-thread CTAs or four 128-thread CTAs an SM put four
// warps on each of the SM's four register files, 128 registers a thread. A warpgroup holds the S and
// O accumulators (64), e as the A operand (16), row sums and addresses;
// ptxas reports 108 and no spills. A second S accumulator (FA3's overlap of
// block j + 1's S with block j's exp2) would not fit; a producer warp would
// leave five warps on a register file and 96 registers a thread, under
// which ptxas serialises the wgmmas.
//
// The grid is B*H CTAs: 768 at B=64 (the sampler), 1,536 at B=128 (the
// training shapes). Long heads (4 or more 64-row tiles) take two
// warpgroups a CTA, two CTAs an SM: 2.9 and 5.8 waves; at L=260 (5 tiles)
// one warpgroup does 3 tiles and the other 2, and the ragged last tile (4
// rows at L=260, 1 at L=257) costs a whole tile's products. Short heads (at
// most 3 tiles: L=68 and L=164) take one warpgroup a CTA that walks all
// tiles, four CTAs an SM (42 and 58 KB): their time goes to the copies'
// latency more than to products, and four heads in flight on an SM hide it
// better than two heads with two warpgroups each.

// Head dims. A head is one 64-column tile (D <= 64) or two (64 < D <=
// 128): the template's NT. Each tile is a TMA box of a 4-D tensor map over
// (D, H, L, B), so columns at or past D arrive as zeros, and a head
// narrower than its tiles never reads the next head's columns: the padded
// columns of Q and K add 0 to the scores, those of V give 0 columns of O,
// which the store drops. The scale is the true D's. Two tiles a head
// (D = 128, six heads at width 768) double K, V and Q in shared memory
// (193 KB at L = 260: one CTA of two warpgroups an SM) and O's accumulator
// (64 more registers a thread, so such a CTA takes up to 255); the
// products are the same per head-row, and the exps, B*H*L^2, halve with H.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kMaxHeadDim = 128;
constexpr int kTile = sm90::kTileRows;
constexpr int kTileBytes = sm90::kTileBytes;
// Warpgroups a CTA: two, or one for heads of at most kShortTiles tiles.
constexpr int kShortTiles = 3;
constexpr float kClamp = 80.f;
constexpr int kSmemLimit = 232448;

// 1 KB to align the tiles; nkb K and nkb V blocks and one Q tile a
// warpgroup, each of nt 64-column tiles; barriers: one a key block, one a
// Q tile.
__host__ __device__ constexpr size_t smem_bytes(int nkb, int groups,
                                                int nt) {
  return 1024 + static_cast<size_t>(2 * nkb + groups) * nt * kTileBytes +
         8 * static_cast<size_t>(nkb + groups);
}

// One tile a head: 128 registers a thread either way, two CTAs of two
// warpgroups, or four of one, an SM. Two tiles: half as many CTAs.
template <int kGroups, int NT>
__global__ void __launch_bounds__(128 * kGroups, (NT == 1 ? 4 : 2) / kGroups)
attention_packed_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            __nv_bfloat16* __restrict__ o, int seq_len,
                            int num_heads, int head_dim, float scale_log2) {
  constexpr int kHeadBytes = NT * kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align_tiles(smem_raw);
  const int nkb = (seq_len + kTile - 1) / kTile;
  const int nqt = nkb;
  uint8_t* k_s = smem;                    // block j at j * NT * 8 KB
  uint8_t* v_s = k_s + nkb * kHeadBytes;
  uint8_t* q_s = v_s + nkb * kHeadBytes;  // warpgroup w's at w * NT * 8 KB
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(q_s + kGroups * kHeadBytes);
  uint64_t* q_full = kv_full + nkb;

  const int head = blockIdx.x;
  const int batch = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // A head's NT tiles of 64 rows from `row`, into dst (zeros past D, L).
  auto load_head = [&](uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                       int row) {
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      sm90::tma_load_4d(dst + c * kTileBytes, map, bar, c * 64, head, row,
                        batch);
    }
  };
  if (tid == 0) {
    for (int j = 0; j < nkb; ++j) sm90::mbar_init(&kv_full[j], 1);
    for (int w = 0; w < kGroups; ++w) sm90::mbar_init(&q_full[w], 1);
    sm90::fence_barrier_init();
    // The first Q tiles, then the key blocks in order.
    for (int w = 0; w < kGroups && w < nqt; ++w) {
      sm90::mbar_arrive_expect_tx(&q_full[w], kHeadBytes);
      load_head(q_s + w * kHeadBytes, &tm_q, &q_full[w], w * kTile);
    }
    for (int j = 0; j < nkb; ++j) {
      sm90::mbar_arrive_expect_tx(&kv_full[j], 2 * kHeadBytes);
      load_head(k_s + j * kHeadBytes, &tm_k, &kv_full[j], j * kTile);
      load_head(v_s + j * kHeadBytes, &tm_v, &kv_full[j], j * kTile);
    }
  }
  __syncthreads();

  const int wg = warp / 4;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int tok_stride = num_heads * head_dim;
  __nv_bfloat16* out = o + static_cast<size_t>(batch) * seq_len * tok_stride +
                       head * head_dim;
  uint8_t* my_q = q_s + wg * kHeadBytes;
  // S = Q K_j^T over the head's NT tiles of columns.
  auto scores = [&](float (&sacc)[32], int j) {
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      sm90::gemm_nt(sacc, sm90::desc_k_major(my_q + c * kTileBytes),
                    sm90::desc_k_major(k_s + j * kHeadBytes + c * kTileBytes),
                    c > 0);
    }
  };

  // Once a tile's products are done, the warpgroup's first thread starts
  // the copy of its next tile into the same buffer.
  auto refill_q = [&](int t) {
    if (t + kGroups >= nqt) return;
    if (wg == 0) {
      sm90::named_barrier<1>(128);
    } else {
      sm90::named_barrier<2>(128);
    }
    if (tid % 128 == 0) {
      sm90::mbar_arrive_expect_tx(&q_full[wg], kHeadBytes);
      load_head(my_q, &tm_q, &q_full[wg], (t + kGroups) * kTile);
    }
  };

  for (int t = wg, use = 0; t < nqt; t += kGroups, ++use) {
    sm90::mbar_wait(&q_full[wg], use & 1);
    float sacc[32], oacc[NT][32];
    uint32_t pa[16];
    float sum_lo = 0.f, sum_hi = 0.f;  // rows g and g + 8, this lane's keys

    sm90::mbar_wait(&kv_full[0], 0);
    sm90::wgmma_fence();
    scores(sacc, 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence(sacc);

    for (int j = 0; j < nkb; ++j) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = j * kTile + nt * 8 + 2 * t4 + (i & 1);
          const float x =
              fminf(fmaxf(sacc[4 * nt + i] * scale_log2, -kClamp), kClamp);
          const float e = key < seq_len ? exp2f(x) : 0.f;
          if (i < 2) {
            sum_lo += e;
          } else {
            sum_hi += e;
          }
          sacc[4 * nt + i] = e;
        }
      }
      sm90::pack_a(pa, sacc);
      sm90::wgmma_fence();
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        sm90::gemm_rn(oacc[c], pa,
                      sm90::desc_mn_major(v_s + j * kHeadBytes +
                                          c * kTileBytes),
                      j > 0);
      }
      if (j + 1 < nkb) {
        sm90::mbar_wait(&kv_full[j + 1], 0);
        scores(sacc, j + 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NT; ++c) sm90::fence(oacc[c]);
      sm90::fence(sacc);
    }

    refill_q(t);

    // The four lanes of a group hold disjoint keys of the same rows.
    sum_lo = sm90::quad_sum(sum_lo);
    sum_hi = sm90::quad_sum(sum_hi);
    const int row_lo = t * kTile + (warp % 4) * 16 + g;
    const int row_hi = row_lo + 8;
    __nv_bfloat16* o_lo = out + static_cast<size_t>(row_lo) * tok_stride +
                          2 * t4;
    __nv_bfloat16* o_hi = o_lo + 8 * static_cast<size_t>(tok_stride);
#pragma unroll
    for (int c = 0; c < NT; ++c) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = c * 64 + 8 * nt;  // padded columns are dropped
        if (col >= head_dim) break;
        if (row_lo < seq_len) {
          *reinterpret_cast<uint32_t*>(o_lo + col) = sm90::pack_bf16(
              oacc[c][4 * nt] / sum_lo, oacc[c][4 * nt + 1] / sum_lo);
        }
        if (row_hi < seq_len) {
          *reinterpret_cast<uint32_t*>(o_hi + col) = sm90::pack_bf16(
              oacc[c][4 * nt + 2] / sum_hi, oacc[c][4 * nt + 3] / sum_hi);
        }
      }
    }
  }
}

template <int kGroups, int NT>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, void* o, int batch, int seq_len,
                   int num_heads, int head_dim, float scale_log2,
                   cudaStream_t s) {
  const int nkb = (seq_len + kTile - 1) / kTile;
  const size_t smem = smem_bytes(nkb, kGroups, NT);
  cudaError_t err = cudaFuncSetAttribute(
      attention_packed_fwd_kernel<kGroups, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(num_heads, batch);
  attention_packed_fwd_kernel<kGroups, NT>
      <<<grid, 128 * kGroups, smem, s>>>(tq, tk, tv,
                                         static_cast<__nv_bfloat16*>(o),
                                         seq_len, num_heads, head_dim,
                                         scale_log2);
  return cudaGetLastError();
}

}  // namespace

// Largest head dim the kernel takes; any multiple of 8 up to it.
extern "C" int attention_packed_max_head_dim() { return kMaxHeadDim; }

// Largest sequence length the kernel takes at a head dim (its K and V stay
// resident in the 227 KB of shared memory a block can use).
extern "C" int attention_packed_max_len(int head_dim) {
  const int nt = head_dim > 64 ? 2 : 1;
  int nkb = 1;
  while (smem_bytes(nkb + 1, 2, nt) <= kSmemLimit) ++nkb;
  return nkb * kTile;
}

// q, k, v, o: (B, L, H*head_dim) bf16, contiguous, 16-byte aligned;
// head_dim a multiple of 8 up to 128. scale_log2 = head_dim**-0.5 *
// log2(e) in f32. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// a head dim or length past the limits or a tensor map the driver refuses.
extern "C" int attention_packed_fwd(const void* q, const void* k,
                                    const void* v, void* o, int batch,
                                    int seq_len, int num_heads, int head_dim,
                                    float scale_log2, void* stream) {
  if (head_dim < 8 || head_dim > kMaxHeadDim || head_dim % 8 != 0 ||
      seq_len > attention_packed_max_len(head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tq, tk, tv;
  if (!sm90_host::packed_head_map_d(&tq, q, batch, seq_len, num_heads,
                                    head_dim) ||
      !sm90_host::packed_head_map_d(&tk, k, batch, seq_len, num_heads,
                                    head_dim) ||
      !sm90_host::packed_head_map_d(&tv, v, batch, seq_len, num_heads,
                                    head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nkb = (seq_len + kTile - 1) / kTile;
  const bool one_group = nkb <= kShortTiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (head_dim <= 64) {
    err = one_group ? launch<1, 1>(tq, tk, tv, o, batch, seq_len, num_heads,
                                   head_dim, scale_log2, s)
                    : launch<2, 1>(tq, tk, tv, o, batch, seq_len, num_heads,
                                   head_dim, scale_log2, s);
  } else {
    err = one_group ? launch<1, 2>(tq, tk, tv, o, batch, seq_len, num_heads,
                                   head_dim, scale_log2, s)
                    : launch<2, 2>(tq, tk, tv, o, batch, seq_len, num_heads,
                                   head_dim, scale_log2, s);
  }
  return static_cast<int>(err);
}
