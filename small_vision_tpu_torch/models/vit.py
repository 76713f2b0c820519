"""ViT encoder blocks with AdaLN-zero or in-context conditioning, and the
ViT classifier.

Counterpart of small_vision_tpu/models/vit.py: `_FusedLN`, `MlpBlock`,
the packed q/k/v/out projections, the packed `MultiHeadAttention`,
`Block` and `Encoder`, unrolled (`blocks_00`, ...) or under `scan=True`
in the stacked layout of flax's `nn.scan` (`blocks/<sub>/<leaf>`, each
leaf with a leading depth axis; block i runs on slice i), with JAX's
remat policies and dropout; and the classifier: the position embeddings
(`posemb_sincos_2d`, `get_posemb`, `resample_posemb`), `MAPHead`, `_ViT`
and its factory `ViT` / `Model` (see `_ViT`). Module and parameter names
follow the flax ones. Activations stay packed (B, L, H*D); matmuls run in
`dtype_mm` with f32 parameters cast per call, as flax does.

`attn_impl` picks one of the JAX package's attention configurations:
  "pallas"        unfused Dense layers around the packed attention (K3, K4);
  "pallas_fused"  the whole attention sub-block in `ops.fused_block.fused_mha`
                  (K6) and the whole MLP in `fused_mlp` (K5);
  "xla"           the packed projections around `xla_attention`'s einsums:
                  q scaled before the product, f32 logits and softmax, the
                  probabilities cast to v's dtype;
  "flax"          stock flax `MultiHeadDotProductAttention` in `dtype_mm`:
                  q divided by sqrt(head dim), logits and softmax in the
                  compute dtype.
The parameter tree is the same under all four. "xla" and "flax" are
compositions of matmuls and a softmax, as XLA ops are in JAX (no Pallas
kernel is on their path there); `FusedLN` runs K1/K2 on the card under
every setting (JAX computes the same function in XLA under "xla" and
"flax") and the plain versions on the CPU.

`quant` ("none", "int8" or "int8_all", the JAX modules' values) puts the
MLP's two products ("int8") and also the q, k, v and out-projections
("int8_all") through `ops.quant.int8_dot`, with the bias added after in
the compute dtype, as the JAX modules do. The JAX precedence holds: the
int8 MLP wins over the fused one, so `pallas_fused` with int8 runs no K5;
the fused attention ignores `int8_all`, so `pallas_fused` runs K6 in the
compute dtype. (On the CPU the JAX package takes the fused attention only
in interpret mode, which is the setting the port's tests hold it to.)

Dropout sits at JAX's four sites: after the MLP's gelu, and on the
attention and MLP branches before their residual adds. Its keep masks are
arguments (`draw`, a function of a shape that returns a bool mask), drawn
before each block runs and so before any checkpointed region: a recompute
sees the masks of the forward. With dropout > 0 the fused MLP steps aside,
as in JAX, so `pallas_fused` then launches no K5.

`remat_policy` follows JAX's matrix (`Encoder.__call__`) on
`torch.utils.checkpoint` (`use_reentrant=False`): unrolled, a block is
rematerialised only under "save_attn" and "save_attn_mlp"; under
`scan=True`, under every policy but "none" / None. "nothing_saveable"
keeps a block's inputs only; "everything_saveable" keeps everything (no
recompute); "save_attn" also keeps `attn_out`, the attention output
before the out-projection, and "save_attn_mlp" `attn_out` and `mlp_out`,
the MLP's output before its gate. Under "pallas_fused" `attn_out` does not
exist (K6 includes the out-projection), so, as in JAX, "save_attn" saves
what "nothing_saveable" does and "save_attn_mlp" `mlp_out` alone. The
block's AdaLN vectors (B, 6D) and its input with the conditioning token
are made before the checkpointed regions, so that the autograd graph is
the one of the run without remat and the gradients are the same bits.

Tensor parallelism (Megatron's block, the `tensor_parallel` and `tp_fsdp`
placements of `parallel.sharding`): where the q, k, v and out-projections
hold a tensor rank's H/T heads and the MLP's kernels its hidden/T units,
each half takes its input's gradient summed over the tensor group
(`collectives.identity_grad_sum`), runs on the rank's part (K3/K4, K6 and
K5 on the shard's shapes, the dropout mask after the gelu sliced), and
sums its row-split product over the group in f32
(`collectives.sum_grad_identity`) before adding that layer's bias once;
int8's row-split scales are the group's (`ops.quant.int8_dot`). The
replicated biases of the column-split layers are sliced through
`collectives.scatter`, so their gradients are whole on every rank. JAX
lets GSPMD lay out the residual stream over `tensor` (`constrain(...,
"embed")`); here it stays whole and the same on every rank.
"""

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from small_vision_tpu_torch.models.common import (DTYPES, Dense, LayerNorm,
                                                  compute_dtype, dense,
                                                  np_lecun_normal,
                                                  np_xavier_uniform,
                                                  patchify)
from small_vision_tpu_torch.ops.attention import attention_packed
from small_vision_tpu_torch.ops.fused_block import fused_mha, fused_mlp
from small_vision_tpu_torch.ops.layernorm import ln_modulate
from small_vision_tpu_torch.ops.quant import int8_dot
from small_vision_tpu_torch.parallel import collectives
from small_vision_tpu_torch.parallel import ctx as ctx_lib
from small_vision_tpu_torch.parallel import mesh as mesh_lib
from small_vision_tpu_torch.parallel import pipeline as pipeline_lib

ATTN_IMPLS = ("pallas", "pallas_fused", "xla", "flax")
QUANTS = ("none", "int8", "int8_all")
# The JAX policies the port has; "none" (or None) is no remat.
REMAT_POLICIES = ("nothing_saveable", "everything_saveable", "save_attn",
                  "save_attn_mlp", "none")


def check_attn_impl(attn_impl: str) -> str:
  if attn_impl not in ATTN_IMPLS:
    raise ValueError(f"attn_impl={attn_impl!r}: the port has "
                     f"{', '.join(map(repr, ATTN_IMPLS))}")
  return attn_impl


def check_quant(quant: str) -> str:
  if quant not in QUANTS:
    raise ValueError(f"quant={quant!r}: one of {', '.join(map(repr, QUANTS))}")
  return quant


def check_remat_policy(policy: Optional[str]) -> Optional[str]:
  if policy is not None and policy not in REMAT_POLICIES:
    raise ValueError(
        f"remat_policy={policy!r}: the port has "
        f"{', '.join(map(repr, REMAT_POLICIES))} and None; the other "
        "jax.checkpoint_policies are not ported")
  return policy


def dropout(x, keep: Optional[torch.Tensor], rate: float):
  """flax nn.Dropout with the keep mask given: x / keep_prob where kept,
  else 0. keep_prob is rounded to x's dtype first, as JAX rounds the
  weak-typed scalar."""
  if keep is None:
    return x
  keep_prob = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
  return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))


def training_draw(train: bool, rate: float, draw: Optional[Callable]):
  """A forward's dropout mask function `draw`, in training with dropout >
  0, where it is needed (a ValueError without it); else None."""
  if not train or not rate:
    return None
  if draw is None:
    raise ValueError(f"dropout {rate} in training needs dropout_draw, the "
                     "keep masks' draws")
  return draw


def int8_dense(x, kernel, bias, dtype, group=None):
  """`dense` with the product through `int8_dot`: operands cast to the
  compute dtype, the int8 product rounded to it, then the bias (None: no
  bias) added in it (two roundings, as the JAX modules). `group`: the
  tensor group of a row-split product (`int8_dot`)."""
  dt = compute_dtype(x, dtype)
  y = int8_dot(x.to(dt), kernel.to(dt), group)
  return y if bias is None else y + bias.to(dt)


def tp_degree(local: int, whole: int, tp, what: str) -> int:
  """How many tensor ranks share a module whose parameter holds `local`
  of its `whole` heads (or hidden units): 1 when it holds them all, else
  the size of the tensor group `tp`, which must make up the whole."""
  if local == whole:
    return 1
  size = collectives.group_size(tp)
  if size * local != whole:
    raise ValueError(
        f"{what}: the parameters hold {local} of {whole}, and the tensor "
        f"group has {size} processes (a tensor rank's block runs under a "
        "mesh with that `tensor` axis, parallel.ctx.activate_mesh)")
  return size


def sum_partials(y, tp, bias, dt, bias_in_f32: bool):
  """Megatron's g after a row-split product: the ranks' partial `y`
  summed over the tensor group `tp` in f32 (the gradient passes through),
  then the bias added once, in f32 before the one rounding to `dt` (the
  fused kernels' order) or after it, in `dt` (a Dense's)."""
  total = collectives.sum_grad_identity(y.float(), tp)
  if bias_in_f32:
    return (total + bias.float()).to(dt)
  return total.to(dt) + bias.to(dt)


def xla_attention(q, k, v):
  """`ops.attention.xla_attention` on [B, L, H, D]: q times D**-0.5 (the
  scale rounded to q's dtype) before the product, f32 logits, f32
  softmax, the probabilities cast to v's dtype, an f32 product rounded to
  v's dtype."""
  depth = q.shape[-1]
  q = q * torch.tensor(1.0 / np.sqrt(depth), dtype=q.dtype, device=q.device)
  logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
  probs = torch.softmax(logits, dim=-1)
  out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
  return out.to(v.dtype)


def flax_attention(q, k, v):
  """flax's `dot_product_attention` on [B, L, H, D] in the inputs' dtype:
  q divided by sqrt(D) (rounded to that dtype), logits rounded to it, the
  softmax in it, then the product with v."""
  depth = q.shape[-1]
  q = q / torch.tensor(np.float32(np.sqrt(depth)), dtype=q.dtype,
                       device=q.device)
  weights = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
  return torch.einsum("bhqk,bkhd->bqhd", weights, v)


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
  """Dense → gelu (tanh approximation, flax's default) → dropout → Dense;
  under `attn_impl="pallas_fused"` with dropout 0 as one `fused_mlp` on the
  same parameters; with `quant` "int8" or "int8_all" both products through
  `int8_dot`, which wins over the fused MLP.

  Where the parameters hold a tensor rank's block of the hidden units
  (`Dense_0` by columns, `Dense_1` by rows; `tp` the tensor group), the
  input's gradient is summed over the group, `Dense_0`'s bias is sliced
  (its gradient all-gathered), the gelu and the dropout run on the rank's
  units (the mask drawn whole and sliced), and `Dense_1`'s partial product
  is summed over the group before its bias is added once; under int8 its
  scales are the group's (`int8_dot`), and K5 runs on the shard with a
  zero bias."""

  def __init__(self, width: int, mlp_dim: Optional[int], dtype,
               attn_impl: str = "pallas", quant: str = "none",
               dropout: float = 0.0):
    super().__init__()
    hidden = mlp_dim or 4 * width
    self.hidden = hidden
    self.dtype = dtype
    self.dropout = dropout
    self.fused = check_attn_impl(attn_impl) == "pallas_fused" and (
        dropout == 0.0)
    self.int8 = check_quant(quant) != "none"
    self.Dense_0 = Dense(width, hidden, dtype)
    self.Dense_1 = Dense(hidden, width, dtype)

  def forward(self, x, keep=None, tp=None):
    """`keep`: the (B, L, hidden) dropout mask after the gelu, or None.
    `tp`: the tensor group (see the class's doc), or None."""
    dt = compute_dtype(x, self.dtype)
    k0, b0 = self.Dense_0.kernel, self.Dense_0.bias
    k1, b1 = self.Dense_1.kernel, self.Dense_1.bias
    n = tp_degree(k0.shape[1], self.hidden, tp, "MlpBlock")
    group, out_bias = None, b1
    if n > 1:
      (x,) = collectives.identity_grad_sum(tp, x)
      b0 = collectives.scatter(b0, tp, 0)
      if keep is not None:
        keep = keep.chunk(n, -1)[collectives.group_rank(tp)]
      group, out_bias = tp, None
    if self.int8:
      h = int8_dense(x, k0, b0, self.dtype)
      h = dropout(nn.functional.gelu(h, approximate="tanh"), keep,
                  self.dropout)
      y = int8_dense(h, k1, out_bias, self.dtype, group)
    elif self.fused:
      y = fused_mlp(x.to(dt), k0.to(dt), b0.to(dt), k1.to(dt),
                    (b1 if n == 1 else torch.zeros_like(b1)).to(dt))
    else:
      h = nn.functional.gelu(dense(x, k0, b0, self.dtype), approximate="tanh")
      y = dense(dropout(h, keep, self.dropout), k1, out_bias, self.dtype)
    if n == 1:
      return y
    return sum_partials(y, tp, b1, dt, self.fused and not self.int8)


class PackedProj(nn.Module):
  """q/k/v projection: flax DenseGeneral params (kernel (d, H, hd), bias
  (H, hd)) applied as one (d, H*hd) matmul on packed activations, through
  `int8_dot` with `quant="int8"`. A kernel that holds a tensor rank's
  heads takes their slice of the (replicated) bias through
  `collectives.scatter` over `tp`, so that the bias's gradient is whole
  on every rank."""

  def __init__(self, width: int, num_heads: int, head_dim: int, dtype,
               quant: str = "none"):
    super().__init__()
    self.dtype = dtype
    self.dense = int8_dense if quant == "int8" else dense
    self.kernel = nn.Parameter(torch.empty(width, num_heads, head_dim))
    self.bias = nn.Parameter(torch.empty(num_heads, head_dim))

  def _bias(self, tp):
    if self.kernel.shape[1] == self.bias.shape[0]:
      return self.bias
    return collectives.scatter(self.bias, tp, 0)

  def params_2d(self, dtype, tp=None):
    """The (d, H*hd) kernel and (H*hd,) bias in `dtype`, for a fused
    kernel."""
    return (self.kernel.reshape(self.kernel.shape[0], -1).to(dtype),
            self._bias(tp).reshape(-1).to(dtype))

  def forward(self, x, tp=None):
    d_in = self.kernel.shape[0]
    return self.dense(x, self.kernel.reshape(d_in, -1),
                      self._bias(tp).reshape(-1), self.dtype)


class PackedOutProj(nn.Module):
  """Out-projection: kernel (H, hd, d), bias (d,), on packed (B, L, H*hd);
  through `int8_dot` with `quant="int8"`. A kernel that holds a tensor
  rank's heads gives a partial product, summed over `tp` before the bias
  is added once (`sum_partials`; under int8 with the group's scales)."""

  def __init__(self, num_heads: int, head_dim: int, width: int, dtype,
               quant: str = "none"):
    super().__init__()
    self.num_heads = num_heads
    self.dtype = dtype
    self.int8 = quant == "int8"
    self.dense = int8_dense if self.int8 else dense
    self.kernel = nn.Parameter(torch.empty(num_heads, head_dim, width))
    self.bias = nn.Parameter(torch.empty(width))

  def params_2d(self, dtype):
    """The (H*hd, d) kernel and (d,) bias in `dtype`, for a fused kernel."""
    return (self.kernel.reshape(-1, self.kernel.shape[-1]).to(dtype),
            self.bias.to(dtype))

  def forward(self, o, tp=None):
    kernel = self.kernel.reshape(-1, self.kernel.shape[-1])
    if self.kernel.shape[0] == self.num_heads:
      return self.dense(o, kernel, self.bias, self.dtype)
    y = (int8_dense(o, kernel, None, self.dtype, tp) if self.int8
         else dense(o, kernel, None, self.dtype))
    return sum_partials(y, tp, self.bias, compute_dtype(o, self.dtype),
                        False)


class MultiHeadAttention(nn.Module):
  """Self-attention through `ops.attention.attention_packed` (K3, and K4
  for the gradient), `xla_attention` or `flax_attention` (`attn_impl`
  "pallas", "xla", "flax"); under "pallas_fused" the projections and the
  attention as one `fused_mha` (K6) on the same parameters, which ignores
  `quant`; otherwise `quant="int8"` quantizes the projections. "flax"
  computes its projections in `dtype_mm` as flax's DenseGeneral does.

  Megatron's attention half: where the projections hold a tensor rank's
  H/T heads (`tp` the tensor group of T processes), the input's gradient
  is summed over the group, q, k and v are the rank's heads, the
  attention (K3 and K4, K6, `xla`, `flax`) runs on them, and the
  out-projection's partial products are summed before its bias."""

  def __init__(self, width: int, num_heads: int, dtype,
               attn_impl: str = "pallas", quant: str = "none"):
    super().__init__()
    if width % num_heads:
      raise ValueError(f"width {width} not divisible by {num_heads} heads")
    head_dim = width // num_heads
    self.num_heads = num_heads
    self.dtype = dtype
    self.attn_impl = check_attn_impl(attn_impl)
    self.fused = attn_impl == "pallas_fused"
    if quant not in ("none", "int8"):
      raise ValueError(f"attention quant={quant!r}: 'none' or 'int8'")
    if attn_impl == "flax":
      quant = "none"  # stock flax MHA: DenseGeneral projections
    self.query = PackedProj(width, num_heads, head_dim, dtype, quant)
    self.key = PackedProj(width, num_heads, head_dim, dtype, quant)
    self.value = PackedProj(width, num_heads, head_dim, dtype, quant)
    self.out = PackedOutProj(num_heads, head_dim, width, dtype, quant)

  def local_heads(self, tp=None) -> int:
    """The heads this process runs: all of them, or a tensor rank's."""
    heads = self.query.kernel.shape[1]
    tp_degree(heads, self.num_heads, tp, "MultiHeadAttention")
    return heads

  def core(self, x, dry: bool = False, tp=None):
    """The attention output before the out-projection (JAX's `attn_out`),
    packed (B, L, H*hd) (a tensor rank's heads under `tp`). `dry`: a
    rematerialisation that needs only the attention's saved inputs (its
    output is saved); K3 is then not launched. Not under
    "pallas_fused"."""
    heads = self.local_heads(tp)
    if heads != self.num_heads:
      (x,) = collectives.identity_grad_sum(tp, x)
    q, k, v = self.query(x, tp), self.key(x, tp), self.value(x, tp)
    if self.attn_impl == "pallas":
      return attention_packed(q, k, v, heads, dry=dry)
    b, l, hd = q.shape
    split = lambda t: t.reshape(b, l, heads, hd // heads)
    fn = xla_attention if self.attn_impl == "xla" else flax_attention
    return fn(split(q), split(k), split(v)).reshape(b, l, hd)

  def forward(self, x, tp=None):
    if not self.fused:
      return self.out(self.core(x, tp=tp), tp)
    heads = self.local_heads(tp)
    dt = compute_dtype(x, self.dtype)
    wo, bo = self.out.params_2d(dt)
    if heads == self.num_heads:
      return fused_mha(x.to(dt), *self.query.params_2d(dt),
                       *self.key.params_2d(dt), *self.value.params_2d(dt),
                       wo, bo, heads)
    (x,) = collectives.identity_grad_sum(tp, x)
    y = fused_mha(x.to(dt), *self.query.params_2d(dt, tp),
                  *self.key.params_2d(dt, tp), *self.value.params_2d(dt, tp),
                  wo, torch.zeros_like(bo), heads)
    return sum_partials(y, tp, bo, dt, True)


class Block(nn.Module):
  """Pre-LN transformer block.

  With `adaln`, `Dense_0` maps the conditioning vector to the six AdaLN
  vectors (shift/scale/gate for attention and MLP). Without it, the
  conditioning vector joins the sequence as a leading token and is
  stripped after. `quant`: "int8" quantizes the MLP, "int8_all" the
  attention's projections too. `dropout`: the rate at the MLP's hidden
  layer and on both branches; its masks are arguments.

  `forward(x, cond, drops)` is `prepare`, `attn`, `mlp` and `finish` in
  turn; `part` runs one of them (the Encoder's remat regions; the stacked
  layout calls the block through `torch.func.functional_call`, which
  calls `forward`).

  `tp`: the tensor group, where the projections hold a tensor rank's
  heads and hidden units (Megatron's block: `MultiHeadAttention` and
  `MlpBlock`). The residual stream, the LayerNorms (K1, K2), the AdaLN
  vectors and the two branches' dropout masks stay whole and the same on
  every tensor rank; each half sums its partial products over the group
  once in the forward and its input's gradient once in the backward.
  """

  def __init__(self, width: int, mlp_dim: Optional[int], num_heads: int,
               adaln: bool, dtype, attn_impl: str = "pallas",
               quant: str = "none", dropout: float = 0.0):
    super().__init__()
    check_quant(quant)
    self.adaln = adaln
    self.dtype = dtype
    self.dropout = dropout
    self.width = width
    self.hidden = mlp_dim or 4 * width
    if adaln:
      self.Dense_0 = Dense(width, 6 * width, dtype)
    self.LayerNorm_0 = FusedLN(width)
    self.MultiHeadAttention_0 = MultiHeadAttention(
        width, num_heads, dtype, attn_impl,
        "int8" if quant == "int8_all" else "none")
    self.LayerNorm_1 = FusedLN(width)
    self.MlpBlock_0 = MlpBlock(width, mlp_dim, dtype, attn_impl, quant,
                               dropout)

  def draw_masks(self, draw, b: int, l: int, cond: bool = True):
    """The block's three dropout keep masks, in JAX's order (attention
    branch, MLP hidden, MLP branch), for an input of B x L tokens (L
    without the conditioning token, which joins them where `cond` is
    given and the block has no AdaLN); None without dropout."""
    if not self.dropout or draw is None:
      return None
    l += 1 if cond and not self.adaln else 0
    return (draw((b, l, self.width)), draw((b, l, self.hidden)),
            draw((b, l, self.width)))

  def prepare(self, x, cond):
    """(x with the conditioning token, the AdaLN vectors (B, 6D) or None)."""
    if cond is not None and self.adaln:
      return x, self.Dense_0(cond)
    if cond is not None:
      x = torch.cat([cond[:, None, :], x], dim=1)
    return x, None

  def attn(self, x, mods, drops=None, *, o=None, stop=None, dry=False,
           tp=None):
    """The attention sub-block on a prepared input, through its residual
    add. `o`: `attn_out` given (saved by a remat policy) rather than
    computed; `stop="attn_out"` returns it; `dry`: see
    `MultiHeadAttention.core`."""
    shift, scale, gate = mods.chunk(6, -1)[:3] if mods is not None else (
        None, None, None)
    mha = self.MultiHeadAttention_0
    if mha.fused:
      y = mha(self.LayerNorm_0(x, shift, scale).to(self.dtype), tp)
    else:
      if o is None:
        o = mha.core(self.LayerNorm_0(x, shift, scale).to(self.dtype), dry,
                     tp)
        if stop == "attn_out":
          return o
      y = mha.out(o, tp)
    if gate is not None:
      y = gate[:, None, :] * y
    return x + dropout(y, drops[0] if drops else None, self.dropout)

  def mlp(self, x, mods, drops=None, *, m=None, stop=None, tp=None):
    """The MLP sub-block, through its residual add. `m`: `mlp_out` (the
    MLP's output before its gate) given rather than computed;
    `stop="mlp_out"` returns it."""
    shift, scale, gate = mods.chunk(6, -1)[3:] if mods is not None else (
        None, None, None)
    if m is None:
      m = self.MlpBlock_0(self.LayerNorm_1(x, shift, scale).to(self.dtype),
                          drops[1] if drops else None, tp)
      if stop == "mlp_out":
        return m
    y = m if gate is None else gate[:, None, :] * m
    return x + dropout(y, drops[2] if drops else None, self.dropout)

  def finish(self, x, cond):
    if cond is not None and not self.adaln:
      x = x[:, 1:]
    return x

  def forward(self, x, cond=None, drops=None, part=None, tp=None, **kw):
    if part == "prepare":
      return self.prepare(x, cond)
    if part in ("attn", "mlp"):
      return getattr(self, part)(x, cond, drops, tp=tp, **kw)
    if part == "finish":
      return self.finish(x, cond)
    y, mods = self.prepare(x, cond)
    return self.finish(self.mlp(self.attn(y, mods, drops, tp=tp), mods,
                                drops, tp=tp), cond)


def _ckpt(fn, *args):
  return checkpoint(fn, *args, use_reentrant=False)


def remat_block(call: Callable, x, cond, drops, policy: Optional[str],
                fused: bool):
  """One block under `policy` (None: no remat). `call(part, *args, **kw)`
  runs a part of the block (`Block.forward`). Each op of the block runs
  once in the forward whatever the policy, so the autograd graph, and the
  gradients, are those without remat."""
  y, mods = call("prepare", x, cond)
  attn = lambda *a, **kw: call("attn", *a, **kw)
  mlp = lambda *a, **kw: call("mlp", *a, **kw)
  block = lambda y, mods, drops, o=None: mlp(attn(y, mods, drops, o=o), mods,
                                             drops)
  o = None
  if policy in ("save_attn", "save_attn_mlp") and not fused:
    # attn_out is saved; its recompute needs K3's inputs only.
    recomputed = []

    def attn_out(y, mods):
      dry = bool(recomputed)
      recomputed.append(True)
      return attn(y, mods, None, stop="attn_out", dry=dry)
    o = _ckpt(attn_out, y, mods)
  if policy in (None, "none", "everything_saveable"):
    y = block(y, mods, drops)
  elif policy == "save_attn_mlp":
    # mlp_out is saved: the region ends there, and the MLP's gate and
    # residual add run outside it.
    def to_mlp_out(y, mods, drops, o):
      y = attn(y, mods, drops, o=o)
      return y, mlp(y, mods, drops, stop="mlp_out")
    y, m = _ckpt(to_mlp_out, y, mods, drops, o)
    y = mlp(y, mods, drops, m=m)
  else:  # nothing_saveable (and save_attn): the region's inputs only
    y = _ckpt(block, y, mods, drops, o)
  return call("finish", y, cond)


class Encoder(nn.Module):
  """Stack of Blocks and a final flax LayerNorm (`encoder_norm`), whose
  output is f32: unrolled (`blocks_00`, ...), or with `scan` one `blocks`
  module whose every parameter holds the depth's layers stacked on a
  leading axis (flax `nn.scan`'s layout), block i running on slice i.

  `remat_policy`: JAX's matrix (see the module's doc). `dropout`: the
  blocks' rate; `forward`'s `draw(shape)` makes the keep masks (bool) of
  each block before it runs, or None for no dropout.

  Under an active mesh with a `tensor` axis (`parallel.ctx.tensor_group`)
  whose parameters hold a tensor rank's block (the `tensor_parallel`
  placement), every block runs as Megatron's (`Block`); the group is
  bound into each block's call when the forward starts, so that a
  rematerialisation in the backward, on autograd's thread, repeats the
  forward's collectives in the same order on every rank.

  `pipe_stages > 1` pipelines the stack over the active mesh's `pipe` axis
  (`parallel.ctx.activate_mesh`, `parallel.pipeline`), as the JAX Encoder
  does: it needs `scan=True`, a `pipe` axis of `pipe_stages` processes and
  dropout 0, and runs `pipe_microbatches` microbatches (default 4 S). Each
  process runs its stage's layers: its own block of the stack where the
  parameters hold depth / S layers (the `pipeline` sharding the trainer
  keeps), or its slice of the whole stack where they hold every layer.
  A mesh with both `pipe` and `tensor` axes is refused: the JAX trainer
  builds none (ROADMAP.md Queue A).
  """

  def __init__(self, depth: int, width: int, mlp_dim: Optional[int],
               num_heads: int, adaln: bool, dtype,
               attn_impl: str = "pallas", quant: str = "none",
               scan: bool = False,
               remat_policy: Optional[str] = "nothing_saveable",
               dropout: float = 0.0, pipe_stages: int = 0,
               pipe_microbatches: int = 0):
    super().__init__()
    self.depth = depth
    self.scan = scan
    self.pipe_stages = pipe_stages
    self.pipe_microbatches = pipe_microbatches
    self.fused = attn_impl == "pallas_fused"
    policy = check_remat_policy(remat_policy)
    if scan:
      self.policy = None if policy in (None, "none") else policy
    else:
      self.policy = policy if policy in ("save_attn", "save_attn_mlp") else None
    kw = dict(width=width, mlp_dim=mlp_dim, num_heads=num_heads, adaln=adaln,
              dtype=dtype, attn_impl=attn_impl, quant=quant, dropout=dropout)
    if scan:
      self.blocks = Block(**kw)
      for mod in self.blocks.modules():
        for name, p in list(mod.named_parameters(recurse=False)):
          setattr(mod, name, nn.Parameter(
              torch.empty((depth, *p.shape), dtype=p.dtype, device=p.device)))
    else:
      for i in range(depth):
        self.add_module(f"blocks_{i:02d}", Block(**kw))
    self.encoder_norm = LayerNorm(width)

  def _calls(self, tp=None):
    """A function `call(part, *args, **kw)` for each block, in order, each
    running on the tensor group `tp`."""
    if not self.scan:
      return [lambda part, *a, _b=getattr(self, f"blocks_{i:02d}"), **kw:
              _b(*a, part=part, tp=tp, **kw) for i in range(self.depth)]
    names, stacked = zip(*self.blocks.named_parameters())
    layers = list(zip(*(p.unbind(0) for p in stacked)))

    def bind(i):
      params = dict(zip(names, layers[i]))
      return lambda part, *a, **kw: torch.func.functional_call(
          self.blocks, params, a, dict(kw, part=part, tp=tp))
    return [bind(i) for i in range(self.depth)]

  def _pipelined(self, x, cond, policy):
    assert self.scan, "pipe_stages needs scan=True (stacked param layout)"
    assert not self.blocks.dropout, "pipeline path supports dropout=0 only"
    assert self.depth % self.pipe_stages == 0, (self.depth, self.pipe_stages)
    mesh = ctx_lib.current_mesh()
    assert mesh is not None and "pipe" in mesh.axis_names, (
        "pipe_stages needs an active mesh (parallel.ctx.activate_mesh) "
        f"with a 'pipe' axis; got {mesh}")
    if mesh.axis_size("tensor") > 1:
      raise NotImplementedError(
          "pipe_stages on a mesh with a tensor axis: the JAX trainer builds "
          "no such mesh (ROADMAP.md Queue A)")
    n_stages = self.pipe_stages
    assert mesh.shape["pipe"] == n_stages, (
        f"mesh pipe axis {mesh.shape['pipe']} != pipe_stages {n_stages}")
    names, stacked = zip(*self.blocks.named_parameters())
    per_stage = self.depth // n_stages
    if stacked[0].shape[0] == self.depth:  # the whole stack: this stage's
      lo = mesh.coord("pipe") * per_stage
      stacked = [p[lo:lo + per_stage] for p in stacked]
    assert stacked[0].shape[0] == per_stage, (stacked[0].shape, per_stage)

    def block_fn(lp, h, *aux):
      call = lambda part, *a, **kw: torch.func.functional_call(
          self.blocks, lp, a, dict(kw, part=part))
      return remat_block(call, h, aux[0] if aux else None, None, policy,
                         self.fused)
    x = pipeline_lib.pipeline_apply_stacked(
        block_fn, dict(zip(names, stacked)), x, mesh=mesh,
        n_microbatches=self.pipe_microbatches or 4 * n_stages,
        batch_axes=mesh_lib.batch_axes(mesh), aux=cond)
    return self.encoder_norm(x)

  def forward(self, x, cond=None, draw: Optional[Callable] = None):
    policy = self.policy if torch.is_grad_enabled() else None
    if self.pipe_stages > 1:
      return self._pipelined(x, cond, policy)
    blocks = [self.blocks] * self.depth if self.scan else [
        getattr(self, f"blocks_{i:02d}") for i in range(self.depth)]
    for mod, call in zip(blocks, self._calls(ctx_lib.tensor_group())):
      drops = mod.draw_masks(draw, x.shape[0], x.shape[1], cond is not None)
      x = remat_block(call, x, cond, drops, policy, self.fused)
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


def posemb_sincos_2d(h, w, width, temperature=10_000., dtype=torch.float32,
                     device=None):
  """Fixed 2-D sincos position embedding (MoCo-v3 convention), (1, h*w,
  width), computed in f32 and cast to `dtype`."""
  assert width % 4 == 0, "Width must be mult of 4 for sincos posemb"
  f32 = dict(dtype=torch.float32, device=device)
  y, x = torch.meshgrid(torch.arange(h, **f32), torch.arange(w, **f32),
                        indexing="ij")
  omega = torch.arange(width // 4, **f32) / (width // 4 - 1)
  omega = 1. / torch.pow(torch.tensor(temperature, **f32), omega)
  y = torch.einsum("m,d->md", y.flatten(), omega)
  x = torch.einsum("m,d->md", x.flatten(), omega)
  pe = torch.cat([torch.sin(x), torch.cos(x), torch.sin(y), torch.cos(y)],
                 dim=1)
  return pe.to(dtype)[None]


def get_posemb(module, typ, seqshape, width, name, dtype=torch.float32,
               device=None):
  """The position embedding of `typ`: "learn", the parameter `name` of
  `module` ((1, prod(seqshape), width), made by `_ViT`), or "sincos2d"."""
  if typ == "learn":
    return getattr(module, name).to(dtype)
  if typ == "sincos2d":
    return posemb_sincos_2d(*seqshape, width, dtype=dtype, device=device)
  raise ValueError(f"Unknown posemb type: {typ}")


def resample_posemb(old, new):
  """Bilinear posemb grid resize for hi-res finetuning (scipy's zoom of
  order 1 on the host): `old` (1, gs_old**2, D) resized to `new`'s shape,
  in `old`'s dtype and on its device; `old` itself when the shapes
  agree."""
  import scipy.ndimage
  if old.shape == new.shape:
    return old
  gs_old = int(np.sqrt(old.shape[1]))
  gs_new = int(np.sqrt(new.shape[1]))
  grid = old.detach().cpu().float().numpy().reshape(gs_old, gs_old, -1)
  grid = scipy.ndimage.zoom(grid, (gs_new / gs_old, gs_new / gs_old, 1),
                            order=1)
  return torch.from_numpy(grid.reshape(1, gs_new * gs_new, -1)).to(
      old.device, old.dtype)


class MultiHeadDotProductAttention(nn.Module):
  """flax's MultiHeadDotProductAttention without dropout or mask, its
  queries apart from its keys and values: DenseGeneral q, k, v kernels
  (d, H, hd) with biases (H, hd) and the out kernel (H, hd, d) with bias
  (d,), in the inputs' dtype promoted with f32 (flax's default dtype), and
  `flax_attention` between them. A plain composition: no kernel of the
  JAX package is on its path."""

  def __init__(self, width: int, num_heads: int):
    super().__init__()
    if width % num_heads:
      raise ValueError(f"width {width} not divisible by {num_heads} heads")
    head_dim = width // num_heads
    self.num_heads = num_heads
    self.query = PackedProj(width, num_heads, head_dim, None)
    self.key = PackedProj(width, num_heads, head_dim, None)
    self.value = PackedProj(width, num_heads, head_dim, None)
    self.out = PackedOutProj(num_heads, head_dim, width, None)

  def forward(self, inputs_q, inputs_kv):
    split = lambda t: t.reshape(*t.shape[:-1], self.num_heads, -1)
    o = flax_attention(split(self.query(inputs_q)),
                       split(self.key(inputs_kv)),
                       split(self.value(inputs_kv)))
    return self.out(o.reshape(*o.shape[:-2], -1))


class MAPHead(nn.Module):
  """Multihead attention pooling head for the classifier: a learned
  `probe` (1, 1, d) attends over the tokens, then LayerNorm and an f32
  `MlpBlock` on a residual; returns the probe's row, (B, d). It runs in
  f32, the dtype of the encoder's `encoder_norm` output, as in JAX."""

  def __init__(self, width: int, mlp_dim: Optional[int] = None,
               num_heads: int = 12):
    super().__init__()
    self.probe = nn.Parameter(torch.empty(1, 1, width))
    self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
        width, num_heads)
    self.LayerNorm_0 = LayerNorm(width)
    self.MlpBlock_0 = MlpBlock(width, mlp_dim, torch.float32)

  def forward(self, x):
    probe = self.probe.to(x.dtype).expand(x.shape[0], -1, -1)
    x = self.MultiHeadDotProductAttention_0(probe, x)
    y = self.LayerNorm_0(x)
    x = x + self.MlpBlock_0(y)
    return x[:, 0]


class PatchConv(nn.Module):
  """flax nn.Conv(width, (p, p), strides=p, VALID) on NHWC images, with
  torch's Conv2d layout: `weight` (width, C, p, p) (OIHW; flax's HWIO
  `kernel`, carried across by `convert.py`) and `bias` (width,). Computed
  as a reshape and one matmul in `dtype` on the (p·p·C, width) view of the
  kernel (the product rounded, then the bias added, as flax does): the
  same function as the convolution, with no cuDNN call (and its TF32
  default) on the path. Returns (n, H/p, W/p, width)."""

  def __init__(self, patch, channels: int, width: int, dtype):
    super().__init__()
    self.patch = tuple(patch)
    self.dtype = dtype
    self.weight = nn.Parameter(torch.empty(width, channels, *self.patch))
    self.bias = nn.Parameter(torch.empty(width))

  def forward(self, image):
    x = patchify(image, self.patch)
    kernel = self.weight.permute(2, 3, 1, 0).reshape(x.shape[-1], -1)
    return dense(x, kernel, self.bias, self.dtype)


class _ViT(nn.Module):
  """Plain ViT classifier: JAX's `_ViT` (small_vision_tpu/models/vit.py).

  The patch conv `embedding` in `dtype_mm`; the position embedding
  (`posemb` "learn", a parameter in the stream's dtype, or "sincos2d");
  with `pool_type="tok"` a `cls` token (zero-initialised in JAX, in the
  stream's dtype) before the sequence; the embedding dropout; the
  `Encoder` named `Transformer` (no AdaLN, no conditioning: K1 without
  modulation, and the attention of `attn_impl`; `scan`, `remat_policy`
  and `dropout` as there), whose `encoder_norm` output is f32; then the
  pooling ("map": `MAPHead`; "gap": the mean over tokens; "0" and "tok":
  the first token, "tok" stripping it from `encoded`), `pre_logits` (a
  Dense and tanh, shared by the pooled and the 2-D outputs, when
  `rep_size`) and the `head` Dense (when `num_classes`). `forward` returns
  the logits (or the pre-logits) and the dict `out` of JAX's keys: stem,
  with_posemb, encoded, head_input, pre_logits_2d, pre_logits,
  logits_2d, logits.

  PyTorch makes parameters at construction, so the port takes two sizes
  that JAX reads off the first input: `image_size` (the posemb grid of
  "learn" is image_size / patch_size) and `channels` (the conv kernel's
  input). `head_zeroinit` says how `init_leaf` draws the head.
  With dropout in training, `forward(..., train=True, dropout_draw=fn)`
  takes the keep masks from `fn(shape)`: the embedding's first, then each
  block's (`Encoder`), in JAX's order.
  """

  def __init__(self, num_classes: Optional[int] = None,
               patch_size=(16, 16), width: int = 768, depth: int = 12,
               mlp_dim: Optional[int] = None, num_heads: int = 12,
               posemb: str = "learn", rep_size=False, dropout: float = 0.0,
               pool_type: str = "gap", head_zeroinit: bool = True,
               scan: bool = False,
               remat_policy: Optional[str] = "nothing_saveable",
               dtype_mm: str = "bfloat16", attn_impl: str = "xla",
               image_size=224, channels: int = 3):
    super().__init__()
    if pool_type not in ("map", "gap", "0", "tok"):
      raise ValueError(f"Unknown pool type: '{pool_type}'")
    if posemb not in ("learn", "sincos2d"):
      raise ValueError(f"Unknown posemb type: {posemb}")
    self.num_classes = num_classes
    self.posemb = posemb
    self.pool_type = pool_type
    self.dropout = dropout
    self.head_zeroinit = head_zeroinit
    self.dtype = DTYPES[dtype_mm]
    sizes = (image_size, image_size) if isinstance(image_size, int) else (
        image_size)
    self.grid = tuple(s // p for s, p in zip(sizes, patch_size))
    self.embedding = PatchConv(patch_size, channels, width, self.dtype)
    if posemb == "learn":
      self.pos_embedding = nn.Parameter(torch.empty(
          1, int(np.prod(self.grid)), width, dtype=self.dtype))
    if pool_type == "tok":
      self.cls = nn.Parameter(torch.empty(1, 1, width, dtype=self.dtype))
    self.Transformer = Encoder(
        depth, width, mlp_dim, num_heads, adaln=False, dtype=self.dtype,
        attn_impl=attn_impl, scan=scan, remat_policy=remat_policy,
        dropout=dropout)
    if pool_type == "map":
      self.MAPHead_0 = MAPHead(width, mlp_dim, num_heads)
    if rep_size:
      rep = width if rep_size is True else rep_size
      self.pre_logits = Dense(width, rep)
    else:
      rep = width
    if num_classes:
      self.head = Dense(rep, num_classes)

  def forward(self, image, *, train=False, dropout_draw=None):
    """image (n, H, W, C) → (logits or pre-logits, out)."""
    draw = training_draw(train, self.dropout, dropout_draw)
    out = {}
    x = out["stem"] = self.embedding(image.to(self.dtype))
    n, h, w, c = x.shape
    x = x.reshape(n, h * w, c)
    x = out["with_posemb"] = x + get_posemb(
        self, self.posemb, (h, w), c, "pos_embedding", x.dtype, x.device)
    if self.pool_type == "tok":
      x = torch.cat([self.cls.to(x.dtype).expand(n, -1, -1), x], dim=1)
    if draw is not None:
      x = dropout(x, draw(tuple(x.shape)), self.dropout)
    x = self.Transformer(x, draw=draw)
    encoded = out["encoded"] = x

    if self.pool_type == "map":
      x = out["head_input"] = self.MAPHead_0(x)
    elif self.pool_type == "gap":
      x = out["head_input"] = torch.mean(x, dim=1)
    else:  # "0", "tok"
      x = out["head_input"] = x[:, 0]
      if self.pool_type == "tok":
        encoded = encoded[:, 1:]

    x_2d = encoded.reshape(n, h, w, -1)
    if hasattr(self, "pre_logits"):
      x_2d = torch.tanh(self.pre_logits(x_2d))
      x = torch.tanh(self.pre_logits(x))
    out["pre_logits_2d"] = x_2d
    out["pre_logits"] = x
    if self.num_classes:
      out["logits_2d"] = self.head(x_2d)
      x = out["logits"] = self.head(x)
    return x, out


def ViT(num_classes=None, *, variant=None, **kw):  # noqa: N802
  return _ViT(num_classes, **{**decode_variant(variant), **kw})


Model = ViT  # Factory alias for `models.get_model_module("vit").Model`.


def init_leaf(name: str, shape, rng, model_config: dict):
  """The classifier's leaf `name` as JAX's `_ViT` initialises it, drawn
  from numpy's `rng`, where its initialiser is the model's own; else None,
  and `convert.init_train_params` draws flax's default. The learned posemb
  is normal(1/sqrt(width)); the head's bias is zero and its kernel zero
  under `head_zeroinit` (the default), else lecun-normal; MAPHead's `probe`
  is xavier-uniform over its (1, d) view."""
  parent = name.split("/")[-2] if "/" in name else ""
  if name == "pos_embedding":
    return rng.standard_normal(shape) * (1.0 / np.sqrt(shape[2]))
  if parent == "head":
    if name.endswith("/bias") or model_config.get("head_zeroinit", True):
      return np.zeros(shape)
    return np_lecun_normal(rng, shape, shape[0])
  if name.endswith("/probe"):
    return np_xavier_uniform(rng, shape, shape[-2], shape[-1])
  return None
