"""flax-compatible building blocks: Dense and LayerNorm with flax numerics.

Parameters carry flax's names and shapes (`kernel` (in, out), `bias`,
`scale`), so a flax param tree loads by name (see `convert.py`). Parameters
are created uninitialised: weights come from a checkpoint or from
`convert.init_params`.
"""

from typing import Optional

import torch
from torch import nn

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(x: torch.Tensor, dtype: Optional[torch.dtype]):
  """flax's promote_dtype: `dtype` when given, else x promoted with f32."""
  return dtype if dtype is not None else torch.promote_types(
      x.dtype, torch.float32)


def dense(x, kernel, bias, dtype: Optional[torch.dtype]):
  """flax nn.Dense math on a 2-D kernel: cast all to the compute dtype,
  x @ kernel rounded to it, then the bias added in it (two roundings, as
  XLA does; not a fused addmm)."""
  dt = compute_dtype(x, dtype)
  y = torch.matmul(x.to(dt), kernel.to(dt))
  return y if bias is None else y + bias.to(dt)


class Dense(nn.Module):
  """flax nn.Dense: kernel (d_in, d_out), optional bias (d_out,)."""

  def __init__(self, d_in: int, d_out: int, dtype=None, use_bias=True):
    super().__init__()
    self.dtype = dtype
    self.kernel = nn.Parameter(torch.empty(d_in, d_out))
    self.bias = nn.Parameter(torch.empty(d_out)) if use_bias else None

  def forward(self, x):
    return dense(x, self.kernel, self.bias, self.dtype)


class LayerNorm(nn.Module):
  """flax nn.LayerNorm (eps 1e-6, no dtype): f32 statistics with the fast
  variance E[x²] - E[x]² clipped at 0, output promoted to f32."""

  def __init__(self, width: int, eps: float = 1e-6):
    super().__init__()
    self.eps = eps
    self.scale = nn.Parameter(torch.empty(width))
    self.bias = nn.Parameter(torch.empty(width))

  def forward(self, x):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    mean2 = torch.square(xf).mean(-1, keepdim=True)
    var = torch.clamp(mean2 - torch.square(mean), min=0.0)
    mul = torch.rsqrt(var + self.eps) * self.scale
    return (xf - mean) * mul + self.bias
