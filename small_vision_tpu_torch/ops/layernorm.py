"""LayerNorm(+AdaLN modulate) forward: CUDA kernel and its plain version.

Counterpart of small_vision_tpu/ops/layernorm.py (forward only; the
backward comes with the training slice). Computes
    y = (LN(x) * gamma + beta) * (1 + scale) + shift
with statistics in f32 and eps 1e-6; shift = scale = None gives a plain
LayerNorm. `ln_modulate` runs the plain version for a tensor on the CPU and
the kernel (`csrc/ln_modulate.cu`) for a CUDA tensor, and raises for a CUDA
tensor the kernel does not take.
"""

import ctypes
import functools
from typing import Optional

import torch

from small_vision_tpu_torch.ops import _build

NAME = "ln_modulate_fwd"
SUPPORTED_WIDTHS = (768, 1024)  # UMD-B and UMD-L


def ln_modulate_plain(x, gamma, beta, shift=None, scale=None, eps=1e-6):
  """Plain PyTorch version; mirrors `ln_modulate_reference` of the JAX ops."""
  xf = x.float()
  mean = xf.mean(-1, keepdim=True)
  var = torch.square(xf - mean).mean(-1, keepdim=True)
  y = (xf - mean) * torch.rsqrt(var + eps)
  y = y * gamma.float() + beta.float()
  if shift is not None:
    y = (y * (1.0 + scale[:, None, :].float())
         + shift[:, None, :].float())
  return y.to(x.dtype)


@functools.cache
def _lib():
  lib = _build.library("ln_modulate")
  fn = lib.ln_modulate_fwd
  p, i = ctypes.c_void_p, ctypes.c_int
  fn.argtypes = [p, p, p, p, p, i, p, p, p, i, i, i, ctypes.c_float, p]
  fn.restype = i
  return fn


def _require(cond, msg):
  if not cond:
    raise ValueError(f"{NAME}: {msg}")


def ln_modulate_fwd(x, gamma, beta, shift=None, scale=None, eps=1e-6, *,
                    mean: Optional[torch.Tensor] = None,
                    rstd: Optional[torch.Tensor] = None):
  """Launches the CUDA kernel. x: (B, L, D) bf16 contiguous, D in
  SUPPORTED_WIDTHS; gamma/beta: (D,) f32; shift/scale: (B, D) bf16 with unit
  column stride, or both None; mean/rstd: (B, L) f32 buffers the kernel
  fills, or both None. Returns y (B, L, D) bf16."""
  _require(x.is_cuda, "x must be a CUDA tensor")
  _require(x.dtype == torch.bfloat16, f"x must be bfloat16, got {x.dtype}")
  _require(x.dim() == 3 and x.is_contiguous(),
           f"x must be a contiguous (B, L, D) tensor, got {tuple(x.shape)}")
  b, l, d = x.shape
  _require(d in SUPPORTED_WIDTHS, f"width {d} not in {SUPPORTED_WIDTHS}")
  for name, t in (("gamma", gamma), ("beta", beta)):
    _require(t.device == x.device and t.dtype == torch.float32
             and tuple(t.shape) == (d,) and t.is_contiguous(),
             f"{name} must be a contiguous ({d},) float32 on {x.device}")
  _require((shift is None) == (scale is None),
           "shift and scale must be given together")
  mod_stride = 0
  if shift is not None:
    mod_stride = shift.stride(0)
    for name, t in (("shift", shift), ("scale", scale)):
      _require(t.device == x.device and t.dtype == torch.bfloat16
               and tuple(t.shape) == (b, d) and t.stride(1) == 1
               and t.stride(0) == mod_stride and mod_stride % 8 == 0
               and t.data_ptr() % 16 == 0,
               f"{name} must be a ({b}, {d}) bfloat16 on {x.device} with "
               "unit column stride and 16-byte aligned rows")
  _require((mean is None) == (rstd is None),
           "mean and rstd must be given together")
  if mean is not None:
    for name, t in (("mean", mean), ("rstd", rstd)):
      _require(t.device == x.device and t.dtype == torch.float32
               and tuple(t.shape) == (b, l) and t.is_contiguous(),
               f"{name} must be a contiguous ({b}, {l}) float32")
  _require(x.data_ptr() % 16 == 0, "x must be 16-byte aligned")

  y = torch.empty_like(x)
  if x.numel() == 0:
    return y
  ptr = lambda t: None if t is None else t.data_ptr()
  status = _lib()(
      x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), ptr(shift),
      ptr(scale), mod_stride, y.data_ptr(), ptr(mean), ptr(rstd), b * l, l,
      d, float(eps), torch.cuda.current_stream(x.device).cuda_stream)
  _build.check(status, NAME)
  _build.LAUNCHES[NAME] += 1
  return y


def ln_modulate(x, gamma, beta, shift=None, scale=None, eps=1e-6):
  """The plain version on a CPU tensor, the CUDA kernel on a CUDA tensor."""
  if x.device.type == "cpu":
    return ln_modulate_plain(x, gamma, beta, shift, scale, eps)
  return ln_modulate_fwd(x, gamma, beta, shift, scale, eps)
