"""ViT encoder blocks with AdaLN-zero or in-context conditioning.

Counterpart of small_vision_tpu/models/vit.py for the paths the sampler and
the train step run (`scan=False`, no remat, dropout 0): `_FusedLN`,
`MlpBlock`, the packed q/k/v/out projections, the packed
`MultiHeadAttention`, `Block` and the unrolled `Encoder`. Module and
parameter names follow the flax ones (`blocks_00/LayerNorm_0/scale`, ...).
Activations stay packed (B, L, H*D); matmuls run in `dtype_mm` with f32
parameters cast per call, as flax does.

`attn_impl` picks one of the JAX package's two kernel configurations:
  "pallas"        unfused Dense layers around the packed attention (K3, K4);
  "pallas_fused"  the whole attention sub-block in `ops.fused_block.fused_mha`
                  (K6) and the whole MLP in `fused_mlp` (K5).
The parameter tree is the same under both, and `FusedLN` runs K1/K2 under
both. The JAX package's other settings ("xla", "flax") are not ported and
raise.

`quant` ("none", "int8" or "int8_all", the JAX modules' values) puts the
MLP's two products ("int8") and also the q, k, v and out-projections
("int8_all") through `ops.quant.int8_dot`, with the bias added after in
the compute dtype, as the JAX modules do. The JAX precedence holds: the
int8 MLP wins over the fused one, so `pallas_fused` with int8 runs no K5;
the fused attention ignores `int8_all`, so `pallas_fused` runs K6 in the
compute dtype. (On the CPU the JAX package takes the fused attention only
in interpret mode, which is the setting the port's tests hold it to.)
"""

from typing import Optional

import torch
from torch import nn

from small_vision_tpu_torch.models.common import (Dense, LayerNorm,
                                                  compute_dtype, dense)
from small_vision_tpu_torch.ops.attention import attention_packed
from small_vision_tpu_torch.ops.fused_block import fused_mha, fused_mlp
from small_vision_tpu_torch.ops.layernorm import ln_modulate
from small_vision_tpu_torch.ops.quant import int8_dot

ATTN_IMPLS = ("pallas", "pallas_fused")
QUANTS = ("none", "int8", "int8_all")


def check_attn_impl(attn_impl: str) -> str:
  if attn_impl not in ATTN_IMPLS:
    raise ValueError(f"attn_impl={attn_impl!r}: the port has "
                     f"{' and '.join(map(repr, ATTN_IMPLS))} only")
  return attn_impl


def check_quant(quant: str) -> str:
  if quant not in QUANTS:
    raise ValueError(f"quant={quant!r}: one of {', '.join(map(repr, QUANTS))}")
  return quant


def int8_dense(x, kernel, bias, dtype):
  """`dense` with the product through `int8_dot`: operands cast to the
  compute dtype, the int8 product rounded to it, then the bias added in it
  (two roundings, as the JAX modules)."""
  dt = compute_dtype(x, dtype)
  return int8_dot(x.to(dt), kernel.to(dt)) + bias.to(dt)


class FusedLN(nn.Module):
  """LayerNorm(+AdaLN modulate) with flax LayerNorm params (scale, bias).

  Runs `ops.layernorm.ln_modulate`: the CUDA kernels on the GPU (K1, and
  K2 for the gradient), their plain versions on the CPU. Statistics in
  f32; output in x's dtype.
  """

  def __init__(self, width: int):
    super().__init__()
    self.scale = nn.Parameter(torch.empty(width))
    self.bias = nn.Parameter(torch.empty(width))

  def forward(self, x, shift=None, scale=None):
    return ln_modulate(x, self.scale, self.bias, shift, scale, 1e-6)


class MlpBlock(nn.Module):
  """Dense → gelu (tanh approximation, flax's default) → Dense; under
  `attn_impl="pallas_fused"` as one `fused_mlp` on the same parameters;
  with `quant` "int8" or "int8_all" both products through `int8_dot`,
  which wins over the fused MLP."""

  def __init__(self, width: int, mlp_dim: Optional[int], dtype,
               attn_impl: str = "pallas", quant: str = "none"):
    super().__init__()
    hidden = mlp_dim or 4 * width
    self.dtype = dtype
    self.fused = check_attn_impl(attn_impl) == "pallas_fused"
    self.int8 = check_quant(quant) != "none"
    self.Dense_0 = Dense(width, hidden, dtype)
    self.Dense_1 = Dense(hidden, width, dtype)

  def forward(self, x):
    if self.int8:
      h = int8_dense(x, self.Dense_0.kernel, self.Dense_0.bias, self.dtype)
      h = nn.functional.gelu(h, approximate="tanh")
      return int8_dense(h, self.Dense_1.kernel, self.Dense_1.bias,
                        self.dtype)
    if self.fused:
      dt = compute_dtype(x, self.dtype)
      return fused_mlp(x.to(dt), *(p.to(dt) for p in (
          self.Dense_0.kernel, self.Dense_0.bias,
          self.Dense_1.kernel, self.Dense_1.bias)))
    h = nn.functional.gelu(self.Dense_0(x), approximate="tanh")
    return self.Dense_1(h)


class PackedProj(nn.Module):
  """q/k/v projection: flax DenseGeneral params (kernel (d, H, hd), bias
  (H, hd)) applied as one (d, H*hd) matmul on packed activations, through
  `int8_dot` with `quant="int8"`."""

  def __init__(self, width: int, num_heads: int, head_dim: int, dtype,
               quant: str = "none"):
    super().__init__()
    self.dtype = dtype
    self.dense = int8_dense if quant == "int8" else dense
    self.kernel = nn.Parameter(torch.empty(width, num_heads, head_dim))
    self.bias = nn.Parameter(torch.empty(num_heads, head_dim))

  def params_2d(self, dtype):
    """The (d, H*hd) kernel and (H*hd,) bias in `dtype`, for a fused
    kernel."""
    return (self.kernel.reshape(self.kernel.shape[0], -1).to(dtype),
            self.bias.reshape(-1).to(dtype))

  def forward(self, x):
    d_in = self.kernel.shape[0]
    return self.dense(x, self.kernel.reshape(d_in, -1),
                      self.bias.reshape(-1), self.dtype)


class PackedOutProj(nn.Module):
  """Out-projection: kernel (H, hd, d), bias (d,), on packed (B, L, H*hd);
  through `int8_dot` with `quant="int8"`."""

  def __init__(self, num_heads: int, head_dim: int, width: int, dtype,
               quant: str = "none"):
    super().__init__()
    self.dtype = dtype
    self.dense = int8_dense if quant == "int8" else dense
    self.kernel = nn.Parameter(torch.empty(num_heads, head_dim, width))
    self.bias = nn.Parameter(torch.empty(width))

  def params_2d(self, dtype):
    """The (H*hd, d) kernel and (d,) bias in `dtype`, for a fused kernel."""
    return (self.kernel.reshape(-1, self.kernel.shape[-1]).to(dtype),
            self.bias.to(dtype))

  def forward(self, o):
    return self.dense(o, self.kernel.reshape(-1, self.kernel.shape[-1]),
                      self.bias, self.dtype)


class MultiHeadAttention(nn.Module):
  """Self-attention through `ops.attention.attention_packed` (K3, and K4
  for the gradient); under `attn_impl="pallas_fused"` the projections and
  the attention as one `fused_mha` (K6) on the same parameters, which
  ignores `quant`; otherwise `quant="int8"` quantizes the projections."""

  def __init__(self, width: int, num_heads: int, dtype,
               attn_impl: str = "pallas", quant: str = "none"):
    super().__init__()
    if width % num_heads:
      raise ValueError(f"width {width} not divisible by {num_heads} heads")
    head_dim = width // num_heads
    self.num_heads = num_heads
    self.dtype = dtype
    self.fused = check_attn_impl(attn_impl) == "pallas_fused"
    if quant not in ("none", "int8"):
      raise ValueError(f"attention quant={quant!r}: 'none' or 'int8'")
    self.query = PackedProj(width, num_heads, head_dim, dtype, quant)
    self.key = PackedProj(width, num_heads, head_dim, dtype, quant)
    self.value = PackedProj(width, num_heads, head_dim, dtype, quant)
    self.out = PackedOutProj(num_heads, head_dim, width, dtype, quant)

  def forward(self, x):
    if self.fused:
      dt = compute_dtype(x, self.dtype)
      return fused_mha(x.to(dt), *self.query.params_2d(dt),
                       *self.key.params_2d(dt), *self.value.params_2d(dt),
                       *self.out.params_2d(dt), self.num_heads)
    o = attention_packed(self.query(x), self.key(x), self.value(x),
                         self.num_heads)
    return self.out(o)


class Block(nn.Module):
  """Pre-LN transformer block.

  With `adaln`, `Dense_0` maps the conditioning vector to the six AdaLN
  vectors (shift/scale/gate for attention and MLP). Without it, the
  conditioning vector joins the sequence as a leading token and is
  stripped after. `quant`: "int8" quantizes the MLP, "int8_all" the
  attention's projections too.
  """

  def __init__(self, width: int, mlp_dim: Optional[int], num_heads: int,
               adaln: bool, dtype, attn_impl: str = "pallas",
               quant: str = "none"):
    super().__init__()
    check_quant(quant)
    self.adaln = adaln
    self.dtype = dtype
    if adaln:
      self.Dense_0 = Dense(width, 6 * width, dtype)
    self.LayerNorm_0 = FusedLN(width)
    self.MultiHeadAttention_0 = MultiHeadAttention(
        width, num_heads, dtype, attn_impl,
        "int8" if quant == "int8_all" else "none")
    self.LayerNorm_1 = FusedLN(width)
    self.MlpBlock_0 = MlpBlock(width, mlp_dim, dtype, attn_impl, quant)

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
               num_heads: int, adaln: bool, dtype,
               attn_impl: str = "pallas", quant: str = "none"):
    super().__init__()
    self.depth = depth
    for i in range(depth):
      self.add_module(
          f"blocks_{i:02d}",
          Block(width, mlp_dim, num_heads, adaln, dtype, attn_impl, quant))
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
