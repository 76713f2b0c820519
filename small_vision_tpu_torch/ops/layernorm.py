"""LayerNorm(+AdaLN modulate), forward and backward: CUDA kernels and their
plain versions.

Counterpart of small_vision_tpu/ops/layernorm.py. Computes
    y = (LN(x) * gamma + beta) * (1 + scale) + shift
with statistics in f32 and eps 1e-6; shift = scale = None gives a plain
LayerNorm. The forward is K1 (`csrc/ln_modulate.cu`), the backward K2
(`csrc/ln_modulate_bwd.cu`). `ln_modulate` runs the plain versions for a
tensor on the CPU and the kernels for a CUDA tensor, and raises for a CUDA
tensor a kernel does not take. The kernels take x in bf16 or f32 (shift,
scale, dy and dx in x's dtype; gamma, beta and the statistics f32, as the
JAX kernels take them) at every width from 1 to MAX_WIDTH: bf16 rows of a
multiple of 32 columns up to 2,048 (every width of the ViT and UMD variant
tables) run the bf16 kernels' own instances (`ln_modulate_fwd`,
`ln_modulate_bwd`), and every other input their instances of any dtype
and width (`ln_modulate_fwd_any`, `ln_modulate_bwd_any`), which load
vectors of `load_vector` elements, so that rows of any width are read in
place. A launch in f32 counts under `NAME_F32` / `BWD_NAME_F32`. Without
gradients (the sampler) it is K1 alone, writing no statistics; with
gradients it goes through `LNModulate`, whose forward is K1 with its
mean/rstd buffers and whose backward is K2.

K1's forward is also the operator `torch.ops.svt.ln_modulate_fwd`
(`torch.library.custom_op`: the CUDA implementation is `ln_modulate_fwd`,
the CPU one the plain version, with a fake that gives the output's
shape), which the no-gradient path calls while `torch.export` traces it
(`tools/export_sampler.py`), so that an exported graph holds the kernel;
eagerly it calls the wrapper, as before. The launch count sits in the
wrapper, so a launch from an exported graph counts as one from eager code.
"""

import functools
from typing import Optional

import torch

from small_vision_tpu_torch.ops import _build

NAME = "ln_modulate_fwd"
BWD_NAME = "ln_modulate_bwd"
# Launch counts of the kernels' f32 instances.
NAME_F32 = "ln_modulate_fwd_f32"
BWD_NAME_F32 = "ln_modulate_bwd_f32"
# The kernels take every width from 1 up to MAX_WIDTH (past ViT-22B's
# 6,144), in these dtypes.
MAX_WIDTH = 8192
DTYPES = (torch.bfloat16, torch.float32)
# The bf16 instances' rows: multiples of 32 up to this (every width of the
# ViT and UMD variant tables, mu 32 ... G 1,664).
BF16_ROW_MAX = 2048


def _acc(t):
  """t in its accumulation dtype: f32, or f64 for an f64 tensor (so that
  the plain versions can be checked with gradcheck)."""
  return t.to(torch.promote_types(t.dtype, torch.float32))


def _ln_plain(x, gamma, beta, shift, scale, eps):
  """(y, mean, rstd) of the plain version; mean/rstd are (B, L) f32."""
  xf = _acc(x)
  mean = xf.mean(-1, keepdim=True)
  var = torch.square(xf - mean).mean(-1, keepdim=True)
  rstd = torch.rsqrt(var + eps)
  y = (xf - mean) * rstd
  y = y * _acc(gamma) + _acc(beta)
  if shift is not None:
    y = y * (1.0 + _acc(scale[:, None, :])) + _acc(shift[:, None, :])
  return y.to(x.dtype), mean[..., 0], rstd[..., 0]


def ln_modulate_plain(x, gamma, beta, shift=None, scale=None, eps=1e-6):
  """Plain PyTorch version; mirrors `ln_modulate_reference` of the JAX ops."""
  return _ln_plain(x, gamma, beta, shift, scale, eps)[0]


def ln_modulate_bwd_plain(x, dy, mean, rstd, gamma, beta, scale=None):
  """Plain version of K2; mirrors `_ln_bwd_kernel` formula by formula.

  Not autograd of the forward: the JAX backward recomputes x̂ from the
  saved statistics and sums in f32 in its own order, and so does this.
  Returns (dx in x's dtype, dgamma, dbeta (D,) f32, dshift, dscale (B, D)
  f32, or None for both without modulation).
  """
  xf = _acc(x)
  dyf = _acc(dy)
  xhat = (xf - mean[..., None]) * rstd[..., None]
  g = _acc(gamma)
  dshift = dscale = None
  if scale is not None:
    d_ln = dyf * (1.0 + _acc(scale[:, None, :]))
    ln_out = xhat * g + _acc(beta)
    dscale = (dyf * ln_out).sum(1)
    dshift = dyf.sum(1)
  else:
    d_ln = dyf
  d = x.shape[-1]
  dgamma = (d_ln * xhat).reshape(-1, d).sum(0)
  dbeta = d_ln.reshape(-1, d).sum(0)
  dxhat = d_ln * g
  m1 = dxhat.mean(-1, keepdim=True)
  m2 = (dxhat * xhat).mean(-1, keepdim=True)
  dx = rstd[..., None] * (dxhat - m1 - xhat * m2)
  return dx.to(x.dtype), dgamma, dbeta, dshift, dscale


@functools.cache
def _lib():
  lib = _build.library("ln_modulate")
  return lib.ln_modulate_fwd, lib.ln_modulate_fwd_any


@functools.cache
def _bwd_lib():
  lib = _build.library("ln_modulate_bwd")
  return (lib.ln_modulate_bwd, lib.ln_modulate_bwd_any,
          lib.ln_modulate_bwd_work_words)


def _require(cond, msg, name=NAME):
  if not cond:
    raise ValueError(f"{name}: {msg}")


def check_modulation(x, shift, scale, name):
  """Checks shift/scale as the kernels read them (on the device of x, in
  x's dtype, (B, D) with unit column stride and one row stride); returns
  their row stride (0 without modulation). Needs no card: the tests run it
  on CPU tensors."""
  b, _, d = x.shape
  if shift is None and scale is None:
    return 0
  _require(shift is not None and scale is not None,
           "shift and scale must be given together", name)
  stride = scale.stride(0)
  for n, t in (("shift", shift), ("scale", scale)):
    _require(t.device == x.device and t.dtype == x.dtype
             and tuple(t.shape) == (b, d) and t.stride(1) == 1
             and t.stride(0) == stride,
             f"{n} must be a ({b}, {d}) {x.dtype} on {x.device} with unit "
             "column stride and the row stride of scale", name)
  return stride


def check_input(x, name, what="x"):
  """Checks x (or dy) as the kernels take it: bf16 or f32, a contiguous
  (B, L, D) tensor, D from 1 to MAX_WIDTH. Needs no card: the tests run it
  on CPU tensors."""
  _require(x.dtype in DTYPES,
           f"{what} must be bfloat16 or float32, got {x.dtype}", name)
  _require(x.dim() == 3 and x.is_contiguous(),
           f"{what} must be a contiguous (B, L, D) tensor, got "
           f"{tuple(x.shape)}", name)
  d = x.shape[-1]
  _require(1 <= d <= MAX_WIDTH,
           f"width {d}: the kernels take 1 to {MAX_WIDTH}", name)


def _check_x(x, name, what="x"):
  _require(x.is_cuda, f"{what} must be a CUDA tensor", name)
  check_input(x, name, what)


def load_vector(x, mod_stride, *tensors):
  """The elements of a load of the kernels' any-width instances: the
  largest power of two up to 16 bytes of x's dtype that divides the width
  and the modulation's row stride, and to whose bytes the address of every
  tensor of `tensors` (x's dtype) is aligned."""
  size = x.element_size()
  vec, d = 16 // size, x.shape[-1]
  while vec > 1 and (d % vec or mod_stride % vec or any(
      t.data_ptr() % (vec * size) for t in tensors if t is not None)):
    vec //= 2
  return vec


def bf16_rows(x, mod_stride, *tensors):
  """Whether the bf16 instances take x: bf16, a multiple of 32 columns up
  to BF16_ROW_MAX, and 16-byte vectors everywhere (`load_vector` 8)."""
  d = x.shape[-1]
  return (x.dtype == torch.bfloat16 and d % 32 == 0 and d <= BF16_ROW_MAX
          and load_vector(x, mod_stride, x, *tensors) == 8)


def launch_name(base, x):
  """The launch count a launch on x adds to: `base`, or its f32 name."""
  return base + "_f32" if x.dtype == torch.float32 else base


def _check_vectors(x, name, **vectors):
  d = x.shape[-1]
  for n, t in vectors.items():
    _require(t.device == x.device and t.dtype == torch.float32
             and tuple(t.shape) == (d,) and t.is_contiguous(),
             f"{n} must be a contiguous ({d},) float32 on {x.device}", name)


def _check_stats(x, name, **stats):
  b, l, _ = x.shape
  for n, t in stats.items():
    _require(t.device == x.device and t.dtype == torch.float32
             and tuple(t.shape) == (b, l) and t.is_contiguous(),
             f"{n} must be a contiguous ({b}, {l}) float32", name)


def ln_modulate_fwd(x, gamma, beta, shift=None, scale=None, eps=1e-6, *,
                    mean: Optional[torch.Tensor] = None,
                    rstd: Optional[torch.Tensor] = None):
  """Launches K1. x: (B, L, D) bf16 or f32 contiguous, D from 1 to
  MAX_WIDTH; gamma/beta: (D,) f32; shift/scale: (B, D) in x's dtype with
  unit column stride, or both None; mean/rstd: (B, L) f32 buffers the
  kernel fills, or both None. Returns y (B, L, D) in x's dtype."""
  _check_x(x, NAME)
  b, l, d = x.shape
  _check_vectors(x, NAME, gamma=gamma, beta=beta)
  mod_stride = check_modulation(x, shift, scale, NAME)
  _require((mean is None) == (rstd is None),
           "mean and rstd must be given together")
  if mean is not None:
    _check_stats(x, NAME, mean=mean, rstd=rstd)

  y = torch.empty_like(x)
  if x.numel() == 0:
    return y
  ptr = lambda t: None if t is None else t.data_ptr()
  args = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), ptr(shift),
          ptr(scale), mod_stride, y.data_ptr(), ptr(mean), ptr(rstd), b * l,
          l, d, float(eps))
  fast, fn_any = _lib()
  if bf16_rows(x, mod_stride, y, shift, scale):
    _build.launch(NAME, x.device, fast, *args)
  else:
    vec = load_vector(x, mod_stride, x, y, shift, scale)
    _build.launch(NAME, x.device, fn_any, *args,
                  int(x.dtype == torch.float32), vec)
  _build.LAUNCHES[launch_name(NAME, x)] += 1
  return y


def _bwd_launch(x, dy, mean, rstd, gamma, beta, scale):
  """(a function that launches K2, its outputs (dx, dgamma, dbeta, dshift,
  dscale)) once the arguments are what K2 takes; the outputs and the
  launch's scratch (its partials and ticket counters, which the launch
  zeroes on its stream) are made here, once."""
  _check_x(x, BWD_NAME)
  _check_x(dy, BWD_NAME, "dy")
  _require(dy.shape == x.shape and dy.device == x.device
           and dy.dtype == x.dtype,
           f"dy must match x {tuple(x.shape)} {x.dtype}", BWD_NAME)
  b, l, d = x.shape
  _check_stats(x, BWD_NAME, mean=mean, rstd=rstd)
  _check_vectors(x, BWD_NAME, gamma=gamma, beta=beta)
  mod_stride = check_modulation(x, scale, scale, BWD_NAME)

  fast, fn_any, work_words = _bwd_lib()
  dx = torch.empty_like(x)
  f32 = dict(dtype=torch.float32, device=x.device)
  dgamma, dbeta = torch.empty(d, **f32), torch.empty(d, **f32)
  dshift = dscale = None
  if scale is not None:
    dshift, dscale = torch.empty(b, d, **f32), torch.empty(b, d, **f32)
  work = torch.empty(work_words(b, l, d), **f32)
  ptr = lambda t: None if t is None else t.data_ptr()
  args = (x.data_ptr(), dy.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
          gamma.data_ptr(), beta.data_ptr(), ptr(scale), mod_stride,
          dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), ptr(dshift),
          ptr(dscale), work.data_ptr(), b, l, d)
  if bf16_rows(x, mod_stride, dy, dx, scale):
    launch = lambda: _build.launch(BWD_NAME, x.device, fast, *args)
  else:
    extra = (int(x.dtype == torch.float32),
             load_vector(x, mod_stride, x, dy, dx, scale))
    launch = lambda: _build.launch(BWD_NAME, x.device, fn_any, *args, *extra)
  return launch, (dx, dgamma, dbeta, dshift, dscale)


def ln_modulate_bwd(x, dy, mean, rstd, gamma, beta, scale=None):
  """Launches K2: the arguments and results of `ln_modulate_bwd_plain`.
  x, dy: (B, L, D) bf16 or f32 contiguous (dy in x's dtype), D from 1 to
  MAX_WIDTH; mean, rstd: (B, L) f32 from K1; gamma, beta: (D,) f32;
  scale: (B, D) in x's dtype as K1 reads it, or None.
  One kernel launch: one CTA per batch row, whose last CTA sums dgamma and
  dbeta over the batch in a fixed order (only the tickets that find it are
  atomic), so two launches on the same inputs give the same bits. The
  ticket counters are the call's own, in its scratch."""
  launch, grads = _bwd_launch(x, dy, mean, rstd, gamma, beta, scale)
  if x.numel() == 0:
    for t in grads[1:]:
      if t is not None:
        t.zero_()
    return grads
  launch()
  _build.LAUNCHES[launch_name(BWD_NAME, x)] += 1
  return grads


def ln_modulate_bwd_timer(x, dy, mean, rstd, gamma, beta, scale=None):
  """A function that launches K2 on `ln_modulate_bwd`'s arguments into
  buffers made once, here: without the wrapper's checks and allocations a
  call, so that a run of calls reads K2's device time even where the host
  is slower than the kernel. Each call zeroes the tickets, as a wrapper's
  launch does. For measurement only: it counts no launch."""
  return _bwd_launch(x, dy, mean, rstd, gamma, beta, scale)[0]


class LNModulate(torch.autograd.Function):
  """Differentiable `ln_modulate`: K1 with statistics forward, K2 backward
  on CUDA tensors; the plain versions on CPU tensors.

  As in the JAX custom VJP, dgamma/dbeta stay f32 (the parameter dtype)
  and dshift/dscale are rounded to the dtype of shift/scale before autograd
  assembles them into the gradient of the AdaLN output.
  """

  @staticmethod
  def forward(ctx, x, gamma, beta, shift, scale, eps):
    if x.device.type == "cpu":
      y, mean, rstd = _ln_plain(x, gamma, beta, shift, scale, eps)
    else:
      b, l, _ = x.shape
      mean = torch.empty(b, l, dtype=torch.float32, device=x.device)
      rstd = torch.empty_like(mean)
      y = ln_modulate_fwd(x, gamma, beta, shift, scale, eps, mean=mean,
                          rstd=rstd)
    ctx.save_for_backward(x, mean, rstd, gamma, beta, scale)
    ctx.modulate = shift is not None
    return y

  @staticmethod
  def backward(ctx, dy):
    x, mean, rstd, gamma, beta, scale = ctx.saved_tensors
    dy = dy.contiguous()
    bwd = ln_modulate_bwd_plain if x.device.type == "cpu" else ln_modulate_bwd
    dx, dgamma, dbeta, dshift, dscale = bwd(
        x, dy, mean, rstd, gamma, beta, scale if ctx.modulate else None)
    if ctx.modulate:
      dshift, dscale = dshift.to(scale.dtype), dscale.to(scale.dtype)
    return dx, dgamma, dbeta, dshift, dscale, None


def _needs_grad(*tensors):
  return torch.is_grad_enabled() and any(
      t is not None and t.requires_grad for t in tensors)


@torch.library.custom_op("svt::ln_modulate_fwd", mutates_args=(),
                         device_types="cuda")
def _ln_modulate_op(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    shift: Optional[torch.Tensor],
                    scale: Optional[torch.Tensor], eps: float) -> torch.Tensor:
  return ln_modulate_fwd(x, gamma, beta, shift, scale, eps)


@_ln_modulate_op.register_kernel("cpu")
def _(x, gamma, beta, shift, scale, eps):
  return ln_modulate_plain(x, gamma, beta, shift, scale, eps)


@_ln_modulate_op.register_fake
def _(x, gamma, beta, shift, scale, eps):
  return torch.empty_like(x)


def ln_modulate(x, gamma, beta, shift=None, scale=None, eps=1e-6):
  """The plain versions on a CPU tensor, the CUDA kernels on a CUDA tensor;
  differentiable through `LNModulate` when a gradient is wanted; the
  operator `svt::ln_modulate_fwd` under `torch.export`."""
  if _needs_grad(x, gamma, beta, shift, scale):
    return LNModulate.apply(x, gamma, beta, shift, scale, eps)
  if torch.compiler.is_exporting():
    return _ln_modulate_op(x, gamma, beta, shift, scale, float(eps))
  if x.device.type == "cpu":
    return ln_modulate_plain(x, gamma, beta, shift, scale, eps)
  return ln_modulate_fwd(x, gamma, beta, shift, scale, eps)
