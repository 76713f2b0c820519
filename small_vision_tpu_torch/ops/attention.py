"""Bidirectional attention, forward and backward: on packed (B, L, H*D)
tensors with the clamped exp2 softmax (what the model runs), and on
[B, L, H, D] tensors with the max-shift softmax.

Counterpart of small_vision_tpu/ops/attention.py::attention_packed and
fused_attention_packed. The softmax is the TPU kernel's: exp2 of the
log2e-scaled scores clamped to ±80 (no max shift), the row sum over the
unrounded f32 e, and e rounded to the input dtype before the PV product.
The forward is K3 (`csrc/attention_packed.cu`), the backward K4
(`csrc/attention_packed_bwd.cu`), which recomputes e from q and k.
`attention_packed` runs the plain versions for tensors on the CPU and the
kernels for CUDA tensors, and raises for a CUDA tensor a kernel does not
take. Without gradients (the sampler) it is K3 alone; with gradients it
goes through `AttentionPacked`. K3 and K4 take bf16 and f32 (the TPU
kernels are generic in the dtype; `dtype_mm="float32"` runs them in f32):
f32 inputs run their f32 instances (`csrc/attention_packed_f32.cu`: the
backward's products and the forward's e V in three TF32 passes on the
tensor cores, 3xTF32; the forward's scores in six, on a grid of each row
(`split_grid`), as a pair of f32 values), at every head dim from
1 to 2,048 and L up to 4,096 with no padding, and count under `NAME_F32`
/ `BWD_NAME_F32`; so do K7 and K8 (`csrc/attention_unpacked_f32.cu`, the
same f32 kernels under the max-shift policy, `UNPACKED_NAME_F32` /
`UNPACKED_BWD_NAME_F32`), and K5
and K6 (`ops.fused_block`); what follows is of the bf16 kernels. K9 takes
bf16 only. Every kernel here takes any head dim from 1 to 2,048
(`MAX_HEAD_DIM`; `heads=4` at width 768 gives 192, `heads=3` 256,
`heads=2` 384, `heads=1` 768, `heads=32` at UMD-S's 384 gives 12): the
kernels run multiples of 8, so the wrappers lay the heads of any other out
at the next multiple of 8 with zero columns (`pad_heads`), launch at that
head dim with the true head dim's scale and drop the padded columns of the
outputs (`unpad_heads`). The zero columns add exact zeros to every score
and to dP = dO V^T, and the output columns they give are dropped, so
nothing else changes. L up to 4,096 at every head dim: a head's K and V
stay in shared memory up to 320 keys (D <= 64) or 384 (64 < D <= 128) and
stream through a ring of them past that (ViT-L/16@512, L = 1,024 or 1,025;
ViT-H/14@518, 1,369), and at every length above 128, with the same
arithmetic and the same bits. (From 321 to 832 keys at D <= 64 the
resident layout would fit, but one CTA an SM: it reads slower.) Past 256
(more than four 64-column tiles a head) every operand streams in tile
pairs, the sums over D loop, and the outputs' columns are split across
CTAs, each recomputing the scores; `chunk_tiles` (tests only) stores fewer
column tiles a CTA, with the same bits.

`fused_attention` is the counterpart of the JAX package's older
`fused_attention` / `pallas_attention` on [B, L, H, D]: scores times
head_dim**-0.5, the row max subtracted, exp, the probabilities divided by
their sum in f32 and rounded to the input dtype before the PV product. Its
forward is K7 (`csrc/attention_unpacked.cu`: the Hopper max-shift core of
`csrc/sm90_attention.cuh` that K6's attention stage runs, with exp2 of the
log2(e)-scaled scores), its backward K8 (`csrc/attention_unpacked_bwd.cu`).
A contiguous [B, L, H, D] tensor is the packed (B, L, H*D) one in memory,
so the kernels read heads in place and the JAX wrapper's transposes and
pads have no counterpart. No module of the model calls it.

`attention_ablate` is the counterpart of
scripts/ablate_attention_kernel.py::run_variant: packed attention under one
of seven softmax / matmul arms (K9, `csrc/attention_ablate.cu`), forward
only. Each arm is a softmax policy of the same Hopper core, one change
from the production one (`exp2`, what K6 and K7 run), so the arms tell
where that core's time goes.
"""

import functools

import numpy as np
import torch

from small_vision_tpu_torch.ops import _build

NAME = "attention_packed_fwd"
BWD_NAME = "attention_packed_bwd"
UNPACKED_NAME = "attention_unpacked_fwd"
UNPACKED_BWD_NAME = "attention_unpacked_bwd"
ABLATE_NAME = "attention_ablate"
# Launch counts of K3's, K4's, K7's and K8's f32 instances.
NAME_F32 = "attention_packed_fwd_f32"
BWD_NAME_F32 = "attention_packed_bwd_f32"
UNPACKED_NAME_F32 = "attention_unpacked_fwd_f32"
UNPACKED_BWD_NAME_F32 = "attention_unpacked_bwd_f32"
# The arms of K9, in the order of the kernel's `variant` argument.
ABLATE_VARIANTS = ("prod", "nosoftmax", "nomm", "bf16exp", "exp2", "mulmask",
                   "nomax")
# K3, K4 and K6-K9 take any head dim from 1 up to this (the kernels
# themselves multiples of 8; the wrappers pad the others, `pad_heads`).
MAX_HEAD_DIM = 2048
CLAMP = 80.0   # Softmax stability clamp, in log2 units.


def scale_f32(head_dim: int) -> float:
  """head_dim**-0.5 rounded to f32, as the JAX kernels round it."""
  return float(np.float32(1.0 / np.sqrt(head_dim)))


def scale_log2(head_dim: int) -> float:
  """head_dim**-0.5 * log2(e), rounded as the JAX kernel rounds it (f32)."""
  return float(np.float32(
      (1.0 / np.sqrt(head_dim)) * np.float64(np.float32(np.log2(np.e)))))


def split_tf32(x):
  """(hi, lo) of an f32 tensor as the f32 attention kernels (K3, K4, K7,
  K8) split their operands for 3xTF32 products (`csrc/sm90_f32x3.cuh`): hi
  is x rounded to tf32 (10 mantissa bits, to nearest, ties away from zero,
  as `cvt.rna.tf32.f32` rounds), lo is x - hi (exact in f32) rounded the
  same way, so hi + lo is x to within 2^-22 of it. A product a b is taken
  as a_lo b_hi + a_hi b_lo + a_hi b_hi."""
  rna = lambda t: ((t.contiguous().view(torch.int32) + 0x1000)
                   & ~0x1FFF).view(torch.float32)
  hi = rna(x.to(torch.float32))
  return hi, rna(x.to(torch.float32) - hi)


GRID_BITS = 7   # a row's grid below its largest power of two


def split_grid(x):
  """(p0, p1, p2) of an f32 tensor as the f32 forwards (K3, K7) split the
  rows (the last dim) of Q's and K's 32 columns of a score step
  (`csrc/sm90_f32x3_attention.cuh`'s `split_row`): with 2^E the power of
  two at or below the row's largest |x|, p0 is x rounded to a multiple of
  2^(E - 7) (to nearest, ties to even, as `rintf`), a tf32 value of at
  most 9 bits; (p1, p2) is `split_tf32` of the rest x - p0 (exact in
  f32). A row below 2^-119 keeps no p0. The products of two rows' p0 are
  multiples of one unit, so their sum over 32 columns is exact in f32."""
  x = x.to(torch.float32)
  e = x.abs().amax(-1, keepdim=True).view(torch.int32) >> 23  # biased E
  as_f32 = lambda bits: (bits.clamp(1, 254) << 23).view(torch.float32)
  unit, inv = as_f32(e - GRID_BITS), as_f32(254 + GRID_BITS - e)
  p0 = torch.where(e > GRID_BITS, torch.round(x * inv) * unit,
                   torch.zeros_like(x))
  return (p0, *split_tf32(x - p0))


def _split(t, num_heads):
  """(B, L, H*D) → (B, H, L, D) in f32 (f64 for an f64 tensor, so that
  the plain versions can be checked with gradcheck)."""
  b, l, hd = t.shape
  t = t.reshape(b, l, num_heads, hd // num_heads).transpose(1, 2)
  return t.to(torch.promote_types(t.dtype, torch.float32))


def _merge(t, dtype):
  """(B, H, L, D) → (B, L, H*D) in `dtype`."""
  b, h, l, d = t.shape
  return t.to(dtype).transpose(1, 2).reshape(b, l, h * d)


def padded_head_dim(d: int) -> int:
  """The head dim the kernels run a head of `d` columns at: `d` rounded up
  to a multiple of 8 (a head's TMA row stride is a multiple of 16
  bytes)."""
  return -(-d // 8) * 8


def pad_heads(t, num_heads, dp):
  """(..., H*D) → (..., H*dp): each of the H heads' D columns followed by
  dp - D zeros, as a new contiguous tensor; `t` itself where dp == D. A
  [B, L, H, D] tensor is its last axis as one head (`num_heads` 1). The
  copy reads t once and writes dp / D of its bytes."""
  *lead, hd = t.shape
  d = hd // num_heads
  if dp == d:
    return t
  t = torch.nn.functional.pad(t.reshape(*lead, num_heads, d), (0, dp - d))
  return t.reshape(*lead, num_heads * dp)


def unpad_heads(t, num_heads, d):
  """(..., H*dp) → (..., H*d): each head's first d columns, as a new
  contiguous tensor; `t` itself where dp == d. `pad_heads`' inverse."""
  *lead, hdp = t.shape
  dp = hdp // num_heads
  if dp == d:
    return t
  t = t.reshape(*lead, num_heads, dp)[..., :d].contiguous()
  return t.reshape(*lead, num_heads * d)


def _e(q, k, d):
  """exp2 of the clamped log2-scaled scores, (B, H, L, L) f32."""
  scores = torch.matmul(q, k.transpose(-1, -2)) * scale_log2(d)
  return torch.exp2(torch.clamp(scores, -CLAMP, CLAMP))


def attention_packed_plain(q, k, v, num_heads, scale_dim=None):
  """Plain PyTorch version of `_attn_kernel_packed`'s math. `scale_dim`:
  the head dim whose scale the scores take (by default the heads' own; a
  head zero-padded by `pad_heads` takes its true one)."""
  d = scale_dim or q.shape[-1] // num_heads
  e = _e(_split(q, num_heads), _split(k, num_heads), d)
  s = e.sum(-1, keepdim=True)
  vs = _split(v, num_heads)
  o = torch.matmul(e.to(q.dtype).to(vs.dtype), vs) / s
  return _merge(o, q.dtype)


def attention_packed_bwd_plain(q, k, v, do, num_heads, scale_dim=None):
  """Plain version of K4; mirrors `_attn_bwd_kernel_packed` formula by
  formula, with its rounding points (e, dO·r, dS and Q·r·scale rounded to
  the input dtype before their products; f32 sums). `scale_dim`: as in
  `attention_packed_plain`.

  Not autograd of the forward: the JAX backward treats the ±80 clamp as
  the identity (dS uses the clamped e, nothing is zeroed), and rounds at
  other places than autograd of `attention_packed_plain` would.
  Returns (dq, dk, dv) in q's dtype.
  """
  dt = q.dtype
  d = scale_dim or q.shape[-1] // num_heads
  scale = 1.0 / np.sqrt(d)
  qs, ks, vs, dos = (_split(t, num_heads) for t in (q, k, v, do))
  e = _e(qs, ks, d)
  r = 1.0 / e.sum(-1, keepdim=True)                          # (B, H, L, 1)
  rounded = lambda t: t.to(dt).to(t.dtype)
  dv = torch.matmul(rounded(e).transpose(-1, -2), rounded(dos * r))
  dp = torch.matmul(dos, vs.transpose(-1, -2))
  c = (dp * e).sum(-1, keepdim=True) * r
  ds = rounded(e * (dp - c))
  dq = torch.matmul(ds, ks) * (r * scale)
  dk = torch.matmul(ds.transpose(-1, -2), rounded(qs * (r * scale)))
  return _merge(dq, dt), _merge(dk, dt), _merge(dv, dt)


@functools.cache
def _lib():
  """K3's library (its entry points `attention_packed_fwd`, `_streamed`
  and `_chunked`) and its length limit (a function of the head dim)."""
  lib = _build.library("attention_packed")
  return lib, lib.attention_packed_max_len


@functools.cache
def _bwd_lib():
  lib = _build.library("attention_packed_bwd")
  return lib, lib.attention_packed_bwd_max_len()


@functools.cache
def _f32_lib():
  """K3's and K4's f32 library and its length limit."""
  lib = _build.library("attention_packed_f32")
  return lib, lib.attention_packed_f32_max_len()


def _chunk_args(chunk_tiles, name):
  """The trailing argument of a `_chunked` entry point: `chunk_tiles`, the
  output column tiles a CTA stores past head dim 256 (from 1)."""
  _require(chunk_tiles >= 1, f"chunk_tiles {chunk_tiles}: from 1", name)
  return (int(chunk_tiles),)


def _require(cond, msg, name=NAME):
  if not cond:
    raise ValueError(f"{name}: {msg}")


def _check_each(name, first, tensors, dtypes=(torch.bfloat16,)):
  """Each of `tensors` a contiguous tensor of `first`'s shape, dtype and
  device, that dtype one of `dtypes`; a bf16 one at a 16-byte aligned
  address: the bf16 kernels read their inputs through TMA tensor maps,
  whose base must be so aligned."""
  what = " or ".join(str(d).replace("torch.", "") for d in dtypes)
  for n, t in tensors.items():
    _require(t.dtype in dtypes, f"{n} must be {what}, got {t.dtype}", name)
    _require(t.device == first.device and t.dtype == first.dtype
             and t.shape == first.shape and t.is_contiguous(),
             f"{n} must be a contiguous {first.dtype} "
             f"{tuple(first.shape)} on {first.device}", name)
    _require(t.dtype != torch.bfloat16 or t.data_ptr() % 16 == 0,
             f"{n} must be 16-byte aligned (a TMA tensor map's base)", name)


def check_head_dim(d, name):
  """Raises ValueError naming `name` for a head dim the kernels' wrappers
  do not take: they take 1 to MAX_HEAD_DIM (the kernels multiples of 8,
  the others on heads zero-padded to one, `pad_heads`)."""
  _require(1 <= d <= MAX_HEAD_DIM,
           f"head dim {d}: the kernels take 1 to {MAX_HEAD_DIM}", name)


# K3, K4, K7 and K8 (and K5 and K6) take both; K9 bf16 only.
PACKED_DTYPES = (torch.bfloat16, torch.float32)


def check_packed(name, num_heads, dtypes=(torch.bfloat16,), **tensors):
  """Checks (B, L, H*D) inputs as K3, K4 or K9 take them (`dtypes`:
  PACKED_DTYPES for K3 and K4, bf16 for K9), D from 1 to MAX_HEAD_DIM;
  returns B, L, D. Needs no card: the tests run it on CPU tensors."""
  first = next(iter(tensors.values()))
  _require(first.dim() == 3,
           f"inputs must be (B, L, H*D), got {tuple(first.shape)}", name)
  b, l, hd = first.shape
  _require(num_heads > 0 and hd % num_heads == 0,
           f"width {hd} is not num_heads {num_heads} heads", name)
  d = hd // num_heads
  check_head_dim(d, name)
  _check_each(name, first, tensors, dtypes)
  return b, l, d


def _check(name, num_heads, dtypes=(torch.bfloat16,), **tensors):
  """`check_packed` of CUDA tensors."""
  first = next(iter(tensors.values()))
  _require(first.is_cuda, f"{next(iter(tensors))} must be a CUDA tensor",
           name)
  return check_packed(name, num_heads, dtypes, **tensors)


def _bf16_options_only(name, streamed=False, chunk_tiles=None):
  _require(not streamed and chunk_tiles is None,
           "streamed and chunk_tiles are options of the bf16 kernels", name)


def attention_packed_fwd(q, k, v, num_heads, streamed=False,
                         chunk_tiles=None):
  """Launches K3 on (B, L, H*D) bf16 contiguous q, k, v, D from 1 to 2,048
  (a D that is not a multiple of 8 on copies of q, k, v padded to the next
  one, `pad_heads`, and o cut back, `unpad_heads`). L up to the kernel's
  `attention_packed_max_len(D)`, 4,096 at every head dim: a head's K and V
  stay in shared memory up to 320 keys at D <= 64 (one 64-column tile a
  head) and 384 at 64 < D <= 128 (two), and stream through a ring of
  stages past that, and at every length at D > 128 (three or more
  tiles; past four, O's columns four tiles a CTA). `streamed`: stream
  them at every length (for tests and measurement; the same bits).
  `chunk_tiles` (1 to 4, tests only): O's column tiles a CTA past D = 256
  (the same bits). f32 q, k, v run K3's f32 instance, unpadded, with
  neither option."""
  b, l, d = _check(NAME, num_heads, PACKED_DTYPES, q=q, k=k, v=v)
  if q.dtype == torch.float32:
    _bf16_options_only(NAME, streamed, chunk_tiles)
    lib, max_len = _f32_lib()
    _require(l <= max_len, f"sequence length {l} > {max_len}")
    o = torch.empty_like(q)
    if q.numel() == 0:
      return o
    _build.launch(NAME, q.device, lib.attention_packed_f32_fwd, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), o.data_ptr(), b, l, num_heads,
                  d, scale_log2(d))
    _build.LAUNCHES[NAME_F32] += 1
    return o
  dp = padded_head_dim(d)
  lib, max_len = _lib()
  _require(l <= max_len(dp), f"sequence length {l} > {max_len(dp)} at head "
           f"dim {d}")
  fn, extra = lib.attention_packed_fwd, ()
  if streamed:
    fn = lib.attention_packed_fwd_streamed
  if chunk_tiles is not None:
    fn, extra = lib.attention_packed_fwd_chunked, _chunk_args(chunk_tiles,
                                                              NAME)

  if q.numel() == 0:
    return torch.empty_like(q)
  q, k, v = (pad_heads(t, num_heads, dp) for t in (q, k, v))
  o = torch.empty_like(q)
  _build.launch(NAME, q.device, fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                o.data_ptr(), b, l, num_heads, dp, scale_log2(d), *extra)
  _build.LAUNCHES[NAME] += 1
  return unpad_heads(o, num_heads, d)


def attention_packed_bwd(q, k, v, do, num_heads, chunk_tiles=None):
  """Launches K4 on (B, L, H*D) bf16 contiguous q, k, v, do (D from 1 to
  2,048, padded as K3's, `attention_packed_fwd`); returns (dq, dk, dv).
  Each output element is summed by one warpgroup's accumulator in a fixed
  order (no atomics), so two launches give the same bits. L up to the
  kernel's `attention_packed_bwd_max_len()`, 4096: its shared memory does
  not grow with L (the limit was 384 before K4 moved to wgmma and streamed
  tiles), and 4096 is the longest length the card's tests hold it at.
  `chunk_tiles` (from 1, tests only): at most this many of the outputs'
  column tiles a CTA past D = 256 (the same bits). f32 inputs run K4's f32
  instance (three kernels: the row statistics, dQ, then dK and dV, their
  products 3xTF32 on wgmma, each sum in a fixed order), unpadded, without
  `chunk_tiles`."""
  b, l, d = _check(BWD_NAME, num_heads, PACKED_DTYPES, q=q, k=k, v=v, do=do)
  if q.dtype == torch.float32:
    _bf16_options_only(BWD_NAME, chunk_tiles=chunk_tiles)
    lib, max_len = _f32_lib()
    _require(l <= max_len, f"sequence length {l} > {max_len}", BWD_NAME)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if q.numel() == 0:
      return dq, dk, dv
    r, c = (torch.empty(b, num_heads, l, dtype=torch.float32,
                        device=q.device) for _ in range(2))
    _build.launch(BWD_NAME, q.device, lib.attention_packed_f32_bwd,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), r.data_ptr(),
                  c.data_ptr(), b, l, num_heads, d, scale_log2(d),
                  scale_f32(d))
    _build.LAUNCHES[BWD_NAME_F32] += 1
    return dq, dk, dv
  dp = padded_head_dim(d)
  lib, max_len = _bwd_lib()
  _require(l <= max_len, f"sequence length {l} > {max_len}", BWD_NAME)
  fn, extra = lib.attention_packed_bwd, ()
  if chunk_tiles is not None:
    fn, extra = (lib.attention_packed_bwd_chunked,
                 _chunk_args(chunk_tiles, BWD_NAME))

  if q.numel() == 0:
    return tuple(torch.empty_like(q) for _ in range(3))
  q, k, v, do = (pad_heads(t, num_heads, dp) for t in (q, k, v, do))
  dq, dk, dv = (torch.empty_like(q) for _ in range(3))
  f32 = dict(dtype=torch.float32, device=q.device)
  r = torch.empty(b, num_heads, l, **f32)  # 1 / row sum of e
  c = torch.empty(b, num_heads, l, **f32)  # row sum of dP∘e, times r
  _build.launch(BWD_NAME, q.device, fn, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), r.data_ptr(), c.data_ptr(), b, l, num_heads,
                dp, scale_log2(d), scale_f32(d), *extra)
  _build.LAUNCHES[BWD_NAME] += 1
  return tuple(unpad_heads(t, num_heads, d) for t in (dq, dk, dv))


class AttentionPacked(torch.autograd.Function):
  """Differentiable `attention_packed`: K3 forward and K4 backward on CUDA
  tensors, the plain versions on CPU tensors. Saves q, k, v, as the JAX
  custom VJP does; the backward recomputes e. `dry`: save q, k, v and
  return an unset tensor without computing the attention, for a
  rematerialisation that needs only what is saved (the output was kept)."""

  @staticmethod
  def forward(ctx, q, k, v, num_heads, dry=False):
    ctx.num_heads = num_heads
    ctx.save_for_backward(q, k, v)
    if dry:
      return torch.empty_like(q)
    if q.device.type == "cpu":
      return attention_packed_plain(q, k, v, num_heads)
    return attention_packed_fwd(q, k, v, num_heads)

  @staticmethod
  def backward(ctx, do):
    q, k, v = ctx.saved_tensors
    do = do.contiguous()
    bwd = (attention_packed_bwd_plain if q.device.type == "cpu"
           else attention_packed_bwd)
    return (*bwd(q, k, v, do, ctx.num_heads), None, None)


# K3's forward as an operator that `torch.export` sees (the exported
# sampler, `tools/export_sampler.py`): CUDA is the wrapper, CPU the plain
# version; eager code calls the wrapper itself.
@torch.library.custom_op("svt::attention_packed_fwd", mutates_args=(),
                         device_types="cuda")
def _attention_packed_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int) -> torch.Tensor:
  return attention_packed_fwd(q, k, v, num_heads)


@_attention_packed_op.register_kernel("cpu")
def _(q, k, v, num_heads):
  return attention_packed_plain(q, k, v, num_heads)


@_attention_packed_op.register_fake
def _(q, k, v, num_heads):
  return torch.empty_like(q)


def attention_packed(q, k, v, num_heads, dry=False):
  """The plain versions on CPU tensors, the CUDA kernels on CUDA tensors;
  differentiable through `AttentionPacked` when a gradient is wanted
  (`dry`: see there); the operator `svt::attention_packed_fwd` under
  `torch.export`."""
  if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
    return AttentionPacked.apply(q, k, v, num_heads, dry)
  if torch.compiler.is_exporting():
    return _attention_packed_op(q, k, v, int(num_heads))
  if q.device.type == "cpu":
    return attention_packed_plain(q, k, v, num_heads)
  return attention_packed_fwd(q, k, v, num_heads)


# ---------------------------------------------------------------------------
# [B, L, H, D] tensors, max-shift softmax (K7, K8).
# ---------------------------------------------------------------------------


def _heads_first(t):
  """[B, L, H, D] → (B, H, L, D) in f32 (f64 for an f64 tensor)."""
  return t.transpose(1, 2).to(torch.promote_types(t.dtype, torch.float32))


def _probs(q, k, scale_dim=None):
  """softmax((q k^T) * D**-0.5) with the row max subtracted, (B, H, L, L)
  f32, from heads-first q and k; D is `scale_dim`, by default q's head
  dim."""
  d = scale_dim or q.shape[-1]
  scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / np.sqrt(d))
  e = torch.exp(scores - scores.amax(-1, keepdim=True))
  return e / e.sum(-1, keepdim=True)


def attention_plain(q, k, v, scale_dim=None):
  """Plain PyTorch version of `_attn_kernel`'s math on [B, L, H, D].
  `scale_dim`: as in `attention_packed_plain`."""
  p = _probs(_heads_first(q), _heads_first(k), scale_dim)
  vs = _heads_first(v)
  o = torch.matmul(p.to(q.dtype).to(vs.dtype), vs)
  return o.to(q.dtype).transpose(1, 2)


def attention_bwd_plain(q, k, v, do, scale_dim=None):
  """Plain version of K8; mirrors `_attn_bwd_kernel` formula by formula,
  with its rounding points (P rounded to the input dtype for dV only, dS
  rounded before its products, the scale applied to the f32 dQ and dK).
  `scale_dim`: as in `attention_packed_plain`. Returns (dq, dk, dv),
  [B, L, H, D] in q's dtype."""
  dt = q.dtype
  scale = 1.0 / np.sqrt(scale_dim or q.shape[-1])
  qs, ks, vs, dos = (_heads_first(t) for t in (q, k, v, do))
  rounded = lambda t: t.to(dt).to(t.dtype)
  p = _probs(qs, ks, scale_dim)
  dv = torch.matmul(rounded(p).transpose(-1, -2), dos)
  dp = torch.matmul(dos, vs.transpose(-1, -2))
  ds = rounded(p * (dp - (dp * p).sum(-1, keepdim=True)))
  dq = torch.matmul(ds, ks) * scale
  dk = torch.matmul(ds.transpose(-1, -2), qs) * scale
  return tuple(t.to(dt).transpose(1, 2) for t in (dq, dk, dv))


@functools.cache
def _unpacked_lib():
  """K7's library (its entry points `attention_unpacked_fwd`, `_streamed`
  and `_chunked`) and its length limit (a function of the head dim)."""
  lib = _build.library("attention_unpacked")
  return lib, lib.attention_unpacked_max_len


@functools.cache
def _unpacked_bwd_lib():
  lib = _build.library("attention_unpacked_bwd")
  return lib, lib.attention_unpacked_bwd_max_len()


@functools.cache
def _unpacked_f32_lib():
  """K7's and K8's f32 library and its length limit."""
  lib = _build.library("attention_unpacked_f32")
  return lib, lib.attention_unpacked_f32_max_len()


def check_unpacked(name, **tensors):
  """Checks the [B, L, H, D] bf16 or f32 inputs of K7 or K8, D from 1 to
  MAX_HEAD_DIM; returns B, L, H, D. Needs no card: the tests run it on
  CPU tensors."""
  first = next(iter(tensors.values()))
  _require(first.dim() == 4,
           f"inputs must be [B, L, H, D], got {tuple(first.shape)}", name)
  b, l, h, d = first.shape
  check_head_dim(d, name)
  _check_each(name, first, tensors, PACKED_DTYPES)
  return b, l, h, d


def _check_unpacked(name, **tensors):
  """`check_unpacked` of CUDA tensors."""
  first = next(iter(tensors.values()))
  _require(first.is_cuda, f"{next(iter(tensors))} must be a CUDA tensor",
           name)
  return check_unpacked(name, **tensors)


def unpacked_head_dim(dtype, d):
  """The head dim K7 and K8 run a head of `d` columns at: `d` for f32 (the
  f32 kernels take every head dim), `padded_head_dim(d)` for bf16."""
  return d if dtype == torch.float32 else padded_head_dim(d)


def attention_unpacked_fwd(q, k, v, streamed=False, chunk_tiles=None):
  """Launches K7 on [B, L, H, D] bf16 contiguous, 16-byte aligned q, k,
  v, D from 1 to 2,048 (padded as K3's, `attention_packed_fwd`), or on f32
  ones (K7's f32 instance, unpadded, with neither option; counted under
  UNPACKED_NAME_F32). No atomics: two launches give the same bits. L up
  to the kernel's `attention_unpacked_max_len(D)`, 4,096 at every head
  dim: a head's K and V stay resident in shared memory up to
  320 keys at D <= 64 (one 64-column tile a head) and 384 at 64 < D <=
  128 (two), and stream through a ring of stages past that, every pass
  walking the keys again, and at every length at D > 128 (past 256, O's
  columns four tiles a CTA). `streamed`: stream them at every length
  (for tests and measurement; the same bits). `chunk_tiles` (1 to 4,
  tests only): O's column tiles a CTA past D = 256 (the same bits)."""
  b, l, h, d = _check_unpacked(UNPACKED_NAME, q=q, k=k, v=v)
  if q.dtype == torch.float32:
    _bf16_options_only(UNPACKED_NAME, streamed, chunk_tiles)
    lib, max_len = _unpacked_f32_lib()
    _require(l <= max_len, f"sequence length {l} > {max_len}",
             UNPACKED_NAME)
    o = torch.empty_like(q)
    if q.numel() == 0:
      return o
    _build.launch(UNPACKED_NAME, q.device, lib.attention_unpacked_f32_fwd,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b,
                  l, h, d, scale_log2(d))
    _build.LAUNCHES[UNPACKED_NAME_F32] += 1
    return o
  dp = padded_head_dim(d)
  lib, max_len = _unpacked_lib()
  _require(l <= max_len(dp), f"sequence length {l} > {max_len(dp)} at head "
           f"dim {d}", UNPACKED_NAME)
  fn, extra = lib.attention_unpacked_fwd, ()
  if streamed:
    fn = lib.attention_unpacked_fwd_streamed
  if chunk_tiles is not None:
    fn, extra = (lib.attention_unpacked_fwd_chunked,
                 _chunk_args(chunk_tiles, UNPACKED_NAME))
  if q.numel() == 0:
    return torch.empty_like(q)
  q, k, v = (pad_heads(t, 1, dp) for t in (q, k, v))
  o = torch.empty_like(q)
  _build.launch(UNPACKED_NAME, q.device, fn, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), b, l, h, dp, scale_f32(d),
                *extra)
  _build.LAUNCHES[UNPACKED_NAME] += 1
  return unpad_heads(o, 1, d)


def _unpacked_bwd_buffers(q, k, v, do):
  """(library, (B, L, H, D, the head dim it runs at), and the tensors of
  K8's C entry points in their order: q, k, v, do (bf16 padded,
  `pad_heads`), the outputs dq, dk, dv and the scratch m, r, c) once the
  inputs are what K8 takes; the f32 instance's library for f32."""
  b, l, h, d = _check_unpacked(UNPACKED_BWD_NAME, q=q, k=k, v=v, do=do)
  dp = unpacked_head_dim(q.dtype, d)
  lib, max_len = (_unpacked_f32_lib() if q.dtype == torch.float32
                  else _unpacked_bwd_lib())
  _require(l <= max_len, f"sequence length {l} > {max_len}",
           UNPACKED_BWD_NAME)
  q, k, v, do = (pad_heads(t, 1, dp) for t in (q, k, v, do))
  grads = [torch.empty_like(q) for _ in range(3)]
  # Per query, (B, H, L) f32: the row max of the log2(e)-scaled scores,
  # 1 / row sum and the row sum of dP∘P.
  scratch = [torch.empty(b, h, l, dtype=torch.float32, device=q.device)
             for _ in range(3)]
  return lib, (b, l, h, d, dp), [q, k, v, do, *grads, *scratch]


def attention_unpacked_bwd(q, k, v, do, chunk_tiles=None):
  """Launches K8 on [B, L, H, D] bf16 contiguous, 16-byte aligned q, k,
  v, do, D from 1 to 2,048 (padded as K3's, `attention_packed_fwd`);
  returns (dq, dk, dv). Two kernels, dQ and then dK/dV (past D = 256
  three: the row statistics first), each output element summed by one
  warpgroup in a fixed order (no atomics), so two launches give the same
  bits. L up to `attention_unpacked_bwd_max_len()`, 4,096 at every head
  dim: keys and queries stream through shared memory in 64-row blocks, so
  nothing there grows with L. `chunk_tiles` (from 1, tests only): at most
  this many of the outputs' column tiles a CTA past D = 256 (the same
  bits). f32 inputs run K8's f32 instance (three kernels: the max-shift
  row statistics, dQ, then dK and dV, their products 3xTF32 on wgmma, each
  sum in a fixed order), unpadded, without `chunk_tiles`, counted under
  UNPACKED_BWD_NAME_F32."""
  lib, (b, l, h, d, dp), bufs = _unpacked_bwd_buffers(q, k, v, do)
  grads = tuple(bufs[4:7])
  if q.dtype == torch.float32:
    _bf16_options_only(UNPACKED_BWD_NAME, chunk_tiles=chunk_tiles)
    if q.numel():
      _build.launch(UNPACKED_BWD_NAME, q.device,
                    lib.attention_unpacked_f32_bwd,
                    *(t.data_ptr() for t in bufs), b, l, h, d, scale_log2(d),
                    scale_f32(d))
      _build.LAUNCHES[UNPACKED_BWD_NAME_F32] += 1
    return grads
  if q.numel() == 0:
    return tuple(unpad_heads(t, 1, d) for t in grads)
  fn, extra = lib.attention_unpacked_bwd, ()
  if chunk_tiles is not None:
    fn, extra = (lib.attention_unpacked_bwd_chunked,
                 _chunk_args(chunk_tiles, UNPACKED_BWD_NAME))
  _build.launch(UNPACKED_BWD_NAME, q.device, fn,
                *(t.data_ptr() for t in bufs), b, l, h, dp, scale_f32(d),
                *extra)
  _build.LAUNCHES[UNPACKED_BWD_NAME] += 1
  return tuple(unpad_heads(t, 1, d) for t in grads)


def attention_unpacked_bwd_stages(q, k, v, do):
  """K8's two kernels one by one, to time each: {"dq", "dkdv": a function
  that launches that kernel}, on buffers made here ("dkdv" reads the m, r,
  c that "dq" wrote: launch "dq" first); for f32 its three, {"stats",
  "dq", "dkdv"}, in that order. For measurement only: they count no
  launch."""
  lib, (b, l, h, d, dp), bufs = _unpacked_bwd_buffers(q, k, v, do)
  if q.dtype == torch.float32:
    launch = lambda stage: _build.launch(
        UNPACKED_BWD_NAME, q.device, lib.attention_unpacked_f32_bwd_stage,
        *(t.data_ptr() for t in bufs), b, l, h, d, scale_log2(d),
        scale_f32(d), stage)
    return {"stats": lambda: launch(0), "dq": lambda: launch(1),
            "dkdv": lambda: launch(2)}
  launch = lambda stage: _build.launch(
      UNPACKED_BWD_NAME, q.device, lib.attention_unpacked_bwd_stage,
      *(t.data_ptr() for t in bufs), b, l, h, dp, scale_f32(d), stage)
  return {"dq": lambda: launch(0), "dkdv": lambda: launch(1)}


class FusedAttention(torch.autograd.Function):
  """Differentiable [B, L, H, D] attention: K7 forward and K8 backward on
  CUDA tensors, the plain versions on CPU tensors. Saves q, k, v, as the
  JAX custom VJP does; the backward recomputes the probabilities."""

  @staticmethod
  def forward(ctx, q, k, v):
    ctx.save_for_backward(q, k, v)
    if q.device.type == "cpu":
      return attention_plain(q, k, v)
    return attention_unpacked_fwd(q, k, v)

  @staticmethod
  def backward(ctx, do):
    q, k, v = ctx.saved_tensors
    do = do.contiguous()
    bwd = (attention_bwd_plain if q.device.type == "cpu"
           else attention_unpacked_bwd)
    return bwd(q, k, v, do)


def fused_attention(q, k, v):
  """Attention on [B, L, H, D] with the max-shift softmax: the plain
  versions on CPU tensors, K7 and K8 on CUDA tensors; differentiable
  through `FusedAttention` when a gradient is wanted."""
  if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
    return FusedAttention.apply(q, k, v)
  if q.device.type == "cpu":
    return attention_plain(q, k, v)
  return attention_unpacked_fwd(q, k, v)


# ---------------------------------------------------------------------------
# Packed tensors under one of seven softmax / matmul arms (K9).
# ---------------------------------------------------------------------------


def attention_ablate_plain(q, k, v, num_heads, variant):
  """Plain PyTorch version of `_kernel_variant`'s math on (B, L, H*D), arm
  by arm and step by step.

  The TPU body works on a tile padded to lp = L rounded up to 16 whose rows
  past L are zero. Nothing is padded here: a zero key scores exactly 0 and a
  zero value adds nothing, so the one place the padding shows is `mulmask`,
  whose row max runs over all lp columns and so includes a 0 whenever L is
  not a multiple of 16.
  """
  if variant not in ABLATE_VARIANTS:
    raise ValueError(f"{ABLATE_NAME}: unknown variant {variant!r}, one of "
                     f"{ABLATE_VARIANTS}")
  b, l, hd = q.shape
  d = hd // num_heads
  dt = q.dtype
  scale = scale_f32(d)
  qs, ks, vs = (_split(t, num_heads) for t in (q, k, v))
  if variant == "nomm":
    # No QK product: every score of row i is bf16(q[i, 0] * scale).
    scores = (qs[..., :1] * scale).to(dt).to(qs.dtype).expand(
        b, num_heads, l, l)
  else:
    scores = torch.matmul(qs, ks.transpose(-1, -2)) * scale

  if variant == "nosoftmax":
    probs = (scores * 0.001).to(dt)
  elif variant == "bf16exp":
    m = scores.amax(-1, keepdim=True)
    e = torch.exp((scores - m).to(torch.bfloat16))  # exp in bf16
    s = e.to(scores.dtype).sum(-1, keepdim=True)
    probs = (e.to(scores.dtype) / s).to(dt)
  elif variant == "exp2":
    scores = scores * float(np.float32(np.log2(np.e)))
    e = torch.exp2(scores - scores.amax(-1, keepdim=True))
    probs = (e / e.sum(-1, keepdim=True)).to(dt)
  elif variant == "mulmask":
    m = scores.amax(-1, keepdim=True)
    if l % 16:
      m = m.clamp_min(0.0)  # the padded keys' scores, exactly 0
    e = torch.exp(scores - m)
    probs = (e / e.sum(-1, keepdim=True)).to(dt)
  elif variant == "nomax":
    e = torch.exp(scores)
    probs = (e / e.sum(-1, keepdim=True)).to(dt)
  else:  # prod, and nomm's softmax
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = (e / e.sum(-1, keepdim=True)).to(dt)

  if variant == "nomm":
    # Row i's probability of key 0 times row i's own v[i, 0], a product in
    # the input dtype, on every column of the head.
    vd = vs.to(dt)
    o = (probs[..., :1] * vd[..., :1]).expand(b, num_heads, l, d)
  else:
    o = torch.matmul(probs.to(vs.dtype), vs)
  return _merge(o, dt)


@functools.cache
def _ablate_lib():
  lib = _build.library("attention_ablate")
  return lib.attention_ablate_fwd, lib.attention_ablate_max_len


def attention_ablate_fwd(q, k, v, num_heads, variant):
  """Launches K9's arm `variant` on (B, L, H*D) bf16 contiguous, 16-byte
  aligned q, k, v, D from 1 to 2,048 (padded as K3's,
  `attention_packed_fwd`: the arms read a padded head's column 0 and
  drop its padded output columns); L up to
  `attention_ablate_max_len(D)`, 4,096 at every head dim (K and V stream
  past 320 keys at D <= 64 and 384 up to 128, and at every length above;
  past D = 256 O's columns four tiles a CTA). No atomics: two launches
  give the same bits."""
  _require(variant in ABLATE_VARIANTS,
           f"unknown variant {variant!r}, one of {ABLATE_VARIANTS}",
           ABLATE_NAME)
  b, l, d = _check(ABLATE_NAME, num_heads, q=q, k=k, v=v)
  dp = padded_head_dim(d)
  fn, max_len = _ablate_lib()
  _require(l <= max_len(dp), f"sequence length {l} > {max_len(dp)} at head "
           f"dim {d}", ABLATE_NAME)
  if q.numel() == 0:
    return torch.empty_like(q)
  q, k, v = (pad_heads(t, num_heads, dp) for t in (q, k, v))
  o = torch.empty_like(q)
  _build.launch(ABLATE_NAME, q.device, fn, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), b, l, num_heads, dp,
                scale_f32(d), ABLATE_VARIANTS.index(variant))
  _build.LAUNCHES[ABLATE_NAME] += 1
  return unpad_heads(o, num_heads, d)


def attention_ablate(q, k, v, num_heads, variant):
  """Packed attention under one arm: the plain version on CPU tensors, K9
  on CUDA tensors. Forward only, as the TPU tool."""
  if q.device.type == "cpu":
    return attention_ablate_plain(q, k, v, num_heads, variant)
  return attention_ablate_fwd(q, k, v, num_heads, variant)
