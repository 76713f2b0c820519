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
goes through `AttentionPacked`.

`fused_attention` is the counterpart of the JAX package's older
`fused_attention` / `pallas_attention` on [B, L, H, D]: scores times
head_dim**-0.5, the row max subtracted, exp, the probabilities divided by
their sum in f32 and rounded to the input dtype before the PV product. Its
forward is K7 (`csrc/attention_unpacked.cu`), its backward K8
(`csrc/attention_unpacked_bwd.cu`). A contiguous [B, L, H, D] tensor is
the packed (B, L, H*D) one in memory, so the kernels read heads in place
and the JAX wrapper's transposes and pads have no counterpart. No module
of the model calls it; `ops.fused_block.fused_mha` shares its core.

`attention_ablate` is the counterpart of
scripts/ablate_attention_kernel.py::run_variant: packed attention under one
of seven softmax / matmul arms (K9, `csrc/attention_ablate.cu`), forward
only, the yardsticks that tell where an attention kernel's time goes.
"""

import ctypes
import functools

import numpy as np
import torch

from small_vision_tpu_torch.ops import _build

NAME = "attention_packed_fwd"
BWD_NAME = "attention_packed_bwd"
UNPACKED_NAME = "attention_unpacked_fwd"
UNPACKED_BWD_NAME = "attention_unpacked_bwd"
ABLATE_NAME = "attention_ablate"
# The arms of K9, in the order of the kernel's `variant` argument.
ABLATE_VARIANTS = ("prod", "nosoftmax", "nomm", "bf16exp", "exp2", "mulmask",
                   "nomax")
HEAD_DIM = 64  # The only head dim the kernels take.
CLAMP = 80.0   # Softmax stability clamp, in log2 units.


def scale_log2(head_dim: int) -> float:
  """head_dim**-0.5 * log2(e), rounded as the JAX kernel rounds it (f32)."""
  return float(np.float32(
      (1.0 / np.sqrt(head_dim)) * np.float64(np.float32(np.log2(np.e)))))


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


def _e(q, k, d):
  """exp2 of the clamped log2-scaled scores, (B, H, L, L) f32."""
  scores = torch.matmul(q, k.transpose(-1, -2)) * scale_log2(d)
  return torch.exp2(torch.clamp(scores, -CLAMP, CLAMP))


def attention_packed_plain(q, k, v, num_heads):
  """Plain PyTorch version of `_attn_kernel_packed`'s math."""
  d = q.shape[-1] // num_heads
  e = _e(_split(q, num_heads), _split(k, num_heads), d)
  s = e.sum(-1, keepdim=True)
  vs = _split(v, num_heads)
  o = torch.matmul(e.to(q.dtype).to(vs.dtype), vs) / s
  return _merge(o, q.dtype)


def attention_packed_bwd_plain(q, k, v, do, num_heads):
  """Plain version of K4; mirrors `_attn_bwd_kernel_packed` formula by
  formula, with its rounding points (e, dO·r, dS and Q·r·scale rounded to
  the input dtype before their products; f32 sums).

  Not autograd of the forward: the JAX backward treats the ±80 clamp as
  the identity (dS uses the clamped e, nothing is zeroed), and rounds at
  other places than autograd of `attention_packed_plain` would.
  Returns (dq, dk, dv) in q's dtype.
  """
  dt = q.dtype
  d = q.shape[-1] // num_heads
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
  lib = _build.library("attention_packed")
  fn = lib.attention_packed_fwd
  p, i = ctypes.c_void_p, ctypes.c_int
  fn.argtypes = [p, p, p, p, i, i, i, ctypes.c_float, p]
  fn.restype = i
  lib.attention_packed_max_len.argtypes = []
  lib.attention_packed_max_len.restype = i
  return fn, lib.attention_packed_max_len()


@functools.cache
def _bwd_lib():
  lib = _build.library("attention_packed_bwd")
  fn = lib.attention_packed_bwd
  p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
  fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, f, f, p]
  fn.restype = i
  lib.attention_packed_bwd_max_len.argtypes = []
  lib.attention_packed_bwd_max_len.restype = i
  return fn, lib.attention_packed_bwd_max_len()


def _require(cond, msg, name=NAME):
  if not cond:
    raise ValueError(f"{name}: {msg}")


def _check(name, num_heads, **tensors):
  """Checks the (B, L, H*64) bf16 inputs of a kernel; returns B, L."""
  first = next(iter(tensors.values()))
  _require(first.is_cuda, f"{next(iter(tensors))} must be a CUDA tensor",
           name)
  _require(first.dim() == 3,
           f"inputs must be (B, L, H*D), got {tuple(first.shape)}", name)
  b, l, hd = first.shape
  _require(hd == num_heads * HEAD_DIM,
           f"width {hd} != num_heads {num_heads} * head dim {HEAD_DIM}",
           name)
  for n, t in tensors.items():
    _require(t.device == first.device and t.dtype == torch.bfloat16
             and t.shape == first.shape and t.is_contiguous()
             and t.data_ptr() % 16 == 0,
             f"{n} must be a contiguous, 16-byte aligned bfloat16 "
             f"{tuple(first.shape)} on {first.device}", name)
  return b, l


def attention_packed_fwd(q, k, v, num_heads):
  """Launches K3 on (B, L, H*64) bf16 contiguous q, k, v."""
  b, l = _check(NAME, num_heads, q=q, k=k, v=v)
  fn, max_len = _lib()
  _require(l <= max_len, f"sequence length {l} > {max_len}")

  o = torch.empty_like(q)
  if q.numel() == 0:
    return o
  status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, l,
              num_heads, scale_log2(HEAD_DIM),
              torch.cuda.current_stream(q.device).cuda_stream)
  _build.check(status, NAME)
  _build.LAUNCHES[NAME] += 1
  return o


def attention_packed_bwd(q, k, v, do, num_heads):
  """Launches K4 on (B, L, H*64) bf16 contiguous q, k, v, do; returns
  (dq, dk, dv). Each output element is summed by one thread in a fixed
  order (no atomics), so two launches give the same bits."""
  b, l = _check(BWD_NAME, num_heads, q=q, k=k, v=v, do=do)
  fn, max_len = _bwd_lib()
  _require(l <= max_len, f"sequence length {l} > {max_len}", BWD_NAME)

  dq, dk, dv = (torch.empty_like(q) for _ in range(3))
  if q.numel() == 0:
    return dq, dk, dv
  f32 = dict(dtype=torch.float32, device=q.device)
  r = torch.empty(b, num_heads, l, **f32)  # 1 / row sum of e
  c = torch.empty(b, num_heads, l, **f32)  # row sum of dP∘e, times r
  status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), r.data_ptr(),
              c.data_ptr(), b, l, num_heads, scale_log2(HEAD_DIM),
              float(np.float32(1.0 / np.sqrt(HEAD_DIM))),
              torch.cuda.current_stream(q.device).cuda_stream)
  _build.check(status, BWD_NAME)
  _build.LAUNCHES[BWD_NAME] += 1
  return dq, dk, dv


class AttentionPacked(torch.autograd.Function):
  """Differentiable `attention_packed`: K3 forward and K4 backward on CUDA
  tensors, the plain versions on CPU tensors. Saves q, k, v, as the JAX
  custom VJP does; the backward recomputes e."""

  @staticmethod
  def forward(ctx, q, k, v, num_heads):
    ctx.num_heads = num_heads
    ctx.save_for_backward(q, k, v)
    if q.device.type == "cpu":
      return attention_packed_plain(q, k, v, num_heads)
    return attention_packed_fwd(q, k, v, num_heads)

  @staticmethod
  def backward(ctx, do):
    q, k, v = ctx.saved_tensors
    do = do.contiguous()
    bwd = (attention_packed_bwd_plain if q.device.type == "cpu"
           else attention_packed_bwd)
    return (*bwd(q, k, v, do, ctx.num_heads), None)


def attention_packed(q, k, v, num_heads):
  """The plain versions on CPU tensors, the CUDA kernels on CUDA tensors;
  differentiable through `AttentionPacked` when a gradient is wanted."""
  if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
    return AttentionPacked.apply(q, k, v, num_heads)
  if q.device.type == "cpu":
    return attention_packed_plain(q, k, v, num_heads)
  return attention_packed_fwd(q, k, v, num_heads)


# ---------------------------------------------------------------------------
# [B, L, H, D] tensors, max-shift softmax (K7, K8).
# ---------------------------------------------------------------------------


def _heads_first(t):
  """[B, L, H, D] → (B, H, L, D) in f32 (f64 for an f64 tensor)."""
  return t.transpose(1, 2).to(torch.promote_types(t.dtype, torch.float32))


def _probs(q, k):
  """softmax((q k^T) * D**-0.5) with the row max subtracted, (B, H, L, L)
  f32, from heads-first q and k."""
  scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / np.sqrt(q.shape[-1]))
  e = torch.exp(scores - scores.amax(-1, keepdim=True))
  return e / e.sum(-1, keepdim=True)


def attention_plain(q, k, v):
  """Plain PyTorch version of `_attn_kernel`'s math on [B, L, H, D]."""
  p = _probs(_heads_first(q), _heads_first(k))
  vs = _heads_first(v)
  o = torch.matmul(p.to(q.dtype).to(vs.dtype), vs)
  return o.to(q.dtype).transpose(1, 2)


def attention_bwd_plain(q, k, v, do):
  """Plain version of K8; mirrors `_attn_bwd_kernel` formula by formula,
  with its rounding points (P rounded to the input dtype for dV only, dS
  rounded before its products, the scale applied to the f32 dQ and dK).
  Returns (dq, dk, dv), [B, L, H, D] in q's dtype."""
  dt = q.dtype
  scale = 1.0 / np.sqrt(q.shape[-1])
  qs, ks, vs, dos = (_heads_first(t) for t in (q, k, v, do))
  rounded = lambda t: t.to(dt).to(t.dtype)
  p = _probs(qs, ks)
  dv = torch.matmul(rounded(p).transpose(-1, -2), dos)
  dp = torch.matmul(dos, vs.transpose(-1, -2))
  ds = rounded(p * (dp - (dp * p).sum(-1, keepdim=True)))
  dq = torch.matmul(ds, ks) * scale
  dk = torch.matmul(ds.transpose(-1, -2), qs) * scale
  return tuple(t.to(dt).transpose(1, 2) for t in (dq, dk, dv))


@functools.cache
def _unpacked_lib():
  lib = _build.library("attention_unpacked")
  fn = lib.attention_unpacked_fwd
  p, i = ctypes.c_void_p, ctypes.c_int
  fn.argtypes = [p, p, p, p, i, i, i, ctypes.c_float, p]
  fn.restype = i
  lib.attention_unpacked_max_len.argtypes = []
  lib.attention_unpacked_max_len.restype = i
  return fn, lib.attention_unpacked_max_len()


@functools.cache
def _unpacked_bwd_lib():
  lib = _build.library("attention_unpacked_bwd")
  fn = lib.attention_unpacked_bwd
  p, i = ctypes.c_void_p, ctypes.c_int
  fn.argtypes = [p] * 10 + [i, i, i, ctypes.c_float, p]
  fn.restype = i
  lib.attention_unpacked_bwd_max_len.argtypes = []
  lib.attention_unpacked_bwd_max_len.restype = i
  return fn, lib.attention_unpacked_bwd_max_len()


def _check_unpacked(name, **tensors):
  """Checks the [B, L, H, 64] bf16 inputs of a kernel; returns B, L, H."""
  first = next(iter(tensors.values()))
  _require(first.is_cuda, f"{next(iter(tensors))} must be a CUDA tensor",
           name)
  _require(first.dim() == 4,
           f"inputs must be [B, L, H, D], got {tuple(first.shape)}", name)
  b, l, h, d = first.shape
  _require(d == HEAD_DIM, f"head dim {d} != {HEAD_DIM}", name)
  for n, t in tensors.items():
    _require(t.device == first.device and t.dtype == torch.bfloat16
             and t.shape == first.shape and t.is_contiguous()
             and t.data_ptr() % 16 == 0,
             f"{n} must be a contiguous, 16-byte aligned bfloat16 "
             f"{tuple(first.shape)} on {first.device}", name)
  return b, l, h


def _scale_f32() -> float:
  return float(np.float32(1.0 / np.sqrt(HEAD_DIM)))


def attention_unpacked_fwd(q, k, v):
  """Launches K7 on [B, L, H, 64] bf16 contiguous q, k, v."""
  b, l, h = _check_unpacked(UNPACKED_NAME, q=q, k=k, v=v)
  fn, max_len = _unpacked_lib()
  _require(l <= max_len, f"sequence length {l} > {max_len}", UNPACKED_NAME)
  o = torch.empty_like(q)
  if q.numel() == 0:
    return o
  status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, l,
              h, _scale_f32(), torch.cuda.current_stream(q.device).cuda_stream)
  _build.check(status, UNPACKED_NAME)
  _build.LAUNCHES[UNPACKED_NAME] += 1
  return o


def attention_unpacked_bwd(q, k, v, do):
  """Launches K8 on [B, L, H, 64] bf16 contiguous q, k, v, do; returns
  (dq, dk, dv). Each output element is summed by one thread in a fixed
  order (no atomics), so two launches give the same bits."""
  b, l, h = _check_unpacked(UNPACKED_BWD_NAME, q=q, k=k, v=v, do=do)
  fn, max_len = _unpacked_bwd_lib()
  _require(l <= max_len, f"sequence length {l} > {max_len}",
           UNPACKED_BWD_NAME)
  dq, dk, dv = (torch.empty_like(q) for _ in range(3))
  if q.numel() == 0:
    return dq, dk, dv
  # Row max, 1 / row sum and row sum of dP∘P of every query, (B, H, L) f32.
  m, r, c = (torch.empty(b, h, l, dtype=torch.float32, device=q.device)
             for _ in range(3))
  status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), m.data_ptr(),
              r.data_ptr(), c.data_ptr(), b, l, h, _scale_f32(),
              torch.cuda.current_stream(q.device).cuda_stream)
  _build.check(status, UNPACKED_BWD_NAME)
  _build.LAUNCHES[UNPACKED_BWD_NAME] += 1
  return dq, dk, dv


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
  scale = float(np.float32(1.0 / np.sqrt(d)))
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
  fn = lib.attention_ablate_fwd
  p, i = ctypes.c_void_p, ctypes.c_int
  fn.argtypes = [p, p, p, p, i, i, i, ctypes.c_float, i, p]
  fn.restype = i
  lib.attention_ablate_max_len.argtypes = []
  lib.attention_ablate_max_len.restype = i
  return fn, lib.attention_ablate_max_len()


def attention_ablate_fwd(q, k, v, num_heads, variant):
  """Launches K9's arm `variant` on (B, L, H*64) bf16 contiguous q, k, v."""
  _require(variant in ABLATE_VARIANTS,
           f"unknown variant {variant!r}, one of {ABLATE_VARIANTS}",
           ABLATE_NAME)
  b, l = _check(ABLATE_NAME, num_heads, q=q, k=k, v=v)
  fn, max_len = _ablate_lib()
  _require(l <= max_len, f"sequence length {l} > {max_len}", ABLATE_NAME)
  o = torch.empty_like(q)
  if q.numel() == 0:
    return o
  status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, l,
              num_heads, _scale_f32(), ABLATE_VARIANTS.index(variant),
              torch.cuda.current_stream(q.device).cuda_stream)
  _build.check(status, ABLATE_NAME)
  _build.LAUNCHES[ABLATE_NAME] += 1
  return o


def attention_ablate(q, k, v, num_heads, variant):
  """Packed attention under one arm: the plain version on CPU tensors, K9
  on CUDA tensors. Forward only, as the TPU tool."""
  if q.device.type == "cpu":
    return attention_ablate_plain(q, k, v, num_heads, variant)
  return attention_ablate_fwd(q, k, v, num_heads, variant)
