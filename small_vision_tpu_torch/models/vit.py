"""ViT encoder blocks with AdaLN-zero or in-context conditioning.

Counterpart of small_vision_tpu/models/vit.py for the path the sampler runs:
`_FusedLN`, the unfused `MlpBlock`, the packed q/k/v/out projections, the
packed `MultiHeadAttention`, `Block` and the unrolled `Encoder`. Module and
parameter names follow the flax ones (`blocks_00/LayerNorm_0/scale`, ...).
Activations stay packed (B, L, H*D); matmuls run in `dtype_mm` with f32
parameters cast per call, as flax does.
"""

from typing import Optional

import torch
from torch import nn

from small_vision_tpu_torch.models.common import Dense, LayerNorm, dense
from small_vision_tpu_torch.ops.attention import attention_packed
from small_vision_tpu_torch.ops.layernorm import ln_modulate


class FusedLN(nn.Module):
  """LayerNorm(+AdaLN modulate) with flax LayerNorm params (scale, bias).

  Runs `ops.layernorm.ln_modulate`: the CUDA kernel on the GPU, its plain
  version on the CPU. Statistics in f32; output in x's dtype.
  """

  def __init__(self, width: int):
    super().__init__()
    self.scale = nn.Parameter(torch.empty(width))
    self.bias = nn.Parameter(torch.empty(width))

  def forward(self, x, shift=None, scale=None):
    return ln_modulate(x, self.scale, self.bias, shift, scale, 1e-6)


class MlpBlock(nn.Module):
  """Dense → gelu (tanh approximation, flax's default) → Dense."""

  def __init__(self, width: int, mlp_dim: Optional[int], dtype):
    super().__init__()
    hidden = mlp_dim or 4 * width
    self.Dense_0 = Dense(width, hidden, dtype)
    self.Dense_1 = Dense(hidden, width, dtype)

  def forward(self, x):
    h = nn.functional.gelu(self.Dense_0(x), approximate="tanh")
    return self.Dense_1(h)


class PackedProj(nn.Module):
  """q/k/v projection: flax DenseGeneral params (kernel (d, H, hd), bias
  (H, hd)) applied as one (d, H*hd) matmul on packed activations."""

  def __init__(self, width: int, num_heads: int, head_dim: int, dtype):
    super().__init__()
    self.dtype = dtype
    self.kernel = nn.Parameter(torch.empty(width, num_heads, head_dim))
    self.bias = nn.Parameter(torch.empty(num_heads, head_dim))

  def forward(self, x):
    d_in = self.kernel.shape[0]
    return dense(x, self.kernel.reshape(d_in, -1), self.bias.reshape(-1),
                 self.dtype)


class PackedOutProj(nn.Module):
  """Out-projection: kernel (H, hd, d), bias (d,), on packed (B, L, H*hd)."""

  def __init__(self, num_heads: int, head_dim: int, width: int, dtype):
    super().__init__()
    self.dtype = dtype
    self.kernel = nn.Parameter(torch.empty(num_heads, head_dim, width))
    self.bias = nn.Parameter(torch.empty(width))

  def forward(self, o):
    return dense(o, self.kernel.reshape(-1, self.kernel.shape[-1]),
                 self.bias, self.dtype)


class MultiHeadAttention(nn.Module):
  """Self-attention through `ops.attention.attention_packed`."""

  def __init__(self, width: int, num_heads: int, dtype):
    super().__init__()
    if width % num_heads:
      raise ValueError(f"width {width} not divisible by {num_heads} heads")
    head_dim = width // num_heads
    self.num_heads = num_heads
    self.query = PackedProj(width, num_heads, head_dim, dtype)
    self.key = PackedProj(width, num_heads, head_dim, dtype)
    self.value = PackedProj(width, num_heads, head_dim, dtype)
    self.out = PackedOutProj(num_heads, head_dim, width, dtype)

  def forward(self, x):
    o = attention_packed(self.query(x), self.key(x), self.value(x),
                         self.num_heads)
    return self.out(o)


class Block(nn.Module):
  """Pre-LN transformer block.

  With `adaln`, `Dense_0` maps the conditioning vector to the six AdaLN
  vectors (shift/scale/gate for attention and MLP). Without it, the
  conditioning vector joins the sequence as a leading token and is
  stripped after.
  """

  def __init__(self, width: int, mlp_dim: Optional[int], num_heads: int,
               adaln: bool, dtype):
    super().__init__()
    self.adaln = adaln
    self.dtype = dtype
    if adaln:
      self.Dense_0 = Dense(width, 6 * width, dtype)
    self.LayerNorm_0 = FusedLN(width)
    self.MultiHeadAttention_0 = MultiHeadAttention(width, num_heads, dtype)
    self.LayerNorm_1 = FusedLN(width)
    self.MlpBlock_0 = MlpBlock(width, mlp_dim, dtype)

  def forward(self, x, cond=None):
    use_adaln = cond is not None and self.adaln
    shift_a = scale_a = gate_a = shift_m = scale_m = gate_m = None
    if use_adaln:
      (shift_a, scale_a, gate_a,
       shift_m, scale_m, gate_m) = self.Dense_0(cond).chunk(6, dim=-1)
    elif cond is not None:
      x = torch.cat([cond[:, None, :], x], dim=1)

    y = self.LayerNorm_0(x, shift_a, scale_a).to(self.dtype)
    y = self.MultiHeadAttention_0(y)
    if use_adaln:
      y = gate_a[:, None, :] * y
    x = x + y

    y = self.LayerNorm_1(x, shift_m, scale_m).to(self.dtype)
    y = self.MlpBlock_0(y)
    if use_adaln:
      y = gate_m[:, None, :] * y
    x = x + y

    if cond is not None and not self.adaln:
      x = x[:, 1:]
    return x


class Encoder(nn.Module):
  """Unrolled stack of Blocks (`blocks_00`, ...) and a final flax LayerNorm
  (`encoder_norm`), whose output is f32."""

  def __init__(self, depth: int, width: int, mlp_dim: Optional[int],
               num_heads: int, adaln: bool, dtype):
    super().__init__()
    self.depth = depth
    for i in range(depth):
      self.add_module(f"blocks_{i:02d}",
                      Block(width, mlp_dim, num_heads, adaln, dtype))
    self.encoder_norm = LayerNorm(width)

  def forward(self, x, cond=None):
    for i in range(self.depth):
      x = getattr(self, f"blocks_{i:02d}")(x, cond)
    return self.encoder_norm(x)


def decode_variant(variant):
  """Decodes "B/16"-style variant strings into ViT dims (std. table)."""
  if variant is None:
    return {}
  v, patch = variant, {}
  if "/" in variant:
    v, p = variant.split("/")
    patch = {"patch_size": (int(p), int(p))}
  return {
      "width": {"mu": 32, "Ti": 192, "S": 384, "M": 512, "B": 768,
                "L": 1024, "H": 1280, "g": 1408, "G": 1664}[v],
      "depth": {"mu": 1, "Ti": 12, "S": 12, "M": 12, "B": 12,
                "L": 24, "H": 32, "g": 40, "G": 48}[v],
      "mlp_dim": {"mu": 128, "Ti": 768, "S": 1536, "M": 2048, "B": 3072,
                  "L": 4096, "H": 5120, "g": 6144, "G": 8192}[v],
      "num_heads": {"mu": 2, "Ti": 3, "S": 6, "M": 8, "B": 12,
                    "L": 16, "H": 16, "g": 16, "G": 16}[v],
      **patch,
  }
