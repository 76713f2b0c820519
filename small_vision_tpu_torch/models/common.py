"""flax-compatible building blocks: Dense and LayerNorm with flax numerics,
and `merge_params`, which reconciles a loaded parameter tree with a freshly
initialised one.

Parameters carry flax's names and shapes (`kernel` (in, out), `bias`,
`scale`), so a flax param tree loads by name (see `convert.py`). Parameters
are created uninitialised: weights come from a checkpoint or from
`convert.init_params`.
"""

import math
import re
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from small_vision_tpu_torch.utils.trees import (recover_tree,
                                                tree_flatten_with_names)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_TRUNC_STD = 0.87962566103423978  # std of a normal truncated to ±2


def lecun_normal(shape, fan_in: int, generator: torch.Generator):
  """flax's lecun_normal: a normal truncated to ±2, scaled to variance
  1/fan_in, drawn on the CPU from `generator` (not flax's draws)."""
  w = torch.empty(shape)
  nn.init.trunc_normal_(w, a=-2.0, b=2.0, generator=generator)
  return w * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)


def np_lecun_normal(rng, shape, fan_in: int):
  """flax's lecun_normal drawn with numpy's `rng`: a normal truncated to
  ±2 (jax.random.truncated_normal's support), scaled to variance 1/fan_in."""
  a = rng.standard_normal(shape)
  while True:
    bad = np.abs(a) > 2.0
    if not bad.any():
      break
    a[bad] = rng.standard_normal(int(bad.sum()))
  return a * (np.sqrt(1.0 / fan_in) / _TRUNC_STD)


def np_xavier_uniform(rng, shape, fan_in: int, fan_out: int):
  """flax's xavier_uniform drawn with numpy's `rng`."""
  limit = np.sqrt(6.0 / (fan_in + fan_out))
  return rng.uniform(-limit, limit, shape)


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


def patchify(image, patch):
  """(n, H, W, C) → (n, H/ph, W/pw, ph·pw·C): each patch's pixels in
  (row, column, channel) order, the order of a flax conv kernel's (ph, pw,
  C) axes, so that a VALID conv of stride `patch` is one matmul."""
  n, h, w, c = image.shape
  ph, pw = patch
  x = image.reshape(n, h // ph, ph, w // pw, pw, c).permute(0, 1, 3, 2, 4, 5)
  return x.reshape(n, h // ph, w // pw, ph * pw * c)


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


def merge_params(loaded, inited, dont_load: Sequence[str] = ()):
  """Merges a restored tree into an init tree (nested or flat dicts keyed by
  slash paths); returns a nested dict.

  Rules:
    - names matching any `dont_load` regex keep their fresh init value;
    - names present in both must agree in shape and take the loaded value;
    - names only in `inited` keep init if matched by dont_load, else error;
    - names only in `loaded` are dropped if matched by dont_load, else error.
  """
  patterns = [re.compile(p) for p in dont_load]
  skip = lambda name: any(p.fullmatch(name) for p in patterns)
  loaded_flat = dict(tree_flatten_with_names(loaded))
  inited_flat = dict(tree_flatten_with_names(inited)) if inited else {}

  merged = {}
  for name, init_val in inited_flat.items():
    if skip(name) or name not in loaded_flat:
      if name not in loaded_flat and not skip(name):
        raise ValueError(
            f"Param {name} not found in checkpoint and not in dont_load.")
      merged[name] = init_val
    else:
      load_val = loaded_flat[name]
      if tuple(load_val.shape) != tuple(init_val.shape):
        raise ValueError(
            f"Shape mismatch for {name}: ckpt {tuple(load_val.shape)} vs "
            f"init {tuple(init_val.shape)}")
      merged[name] = load_val

  for name, load_val in loaded_flat.items():
    if name not in merged:
      if not skip(name) and inited_flat:
        raise ValueError(
            f"Checkpoint param {name} has no target and isn't in dont_load.")
      if not inited_flat:
        merged[name] = load_val
  return recover_tree(*zip(*merged.items())) if merged else {}
