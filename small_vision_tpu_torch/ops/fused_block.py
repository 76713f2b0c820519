"""Module-granular fused kernels: the MLP and multi-head attention with its
projections, on packed (B, L, D) tensors.

Counterpart of small_vision_tpu/ops/fused_block.py, which the model runs
under `attn_impl="pallas_fused"`:

  fused_mlp:  y = bf16(f32(bf16(gelu_tanh(f32(x W1) + b1)) W2) + b2)
              K5 (`csrc/fused_mlp.cu`): two launches of a wgmma GEMM, the
              up-projection with the bias and gelu on its accumulator, the
              down-projection with the bias; the bf16 (B, L, hidden)
              activations make one round trip through device memory.
  fused_mha:  q, k, v = bf16(f32(x W) + b); per head the max-shift softmax
              attention of `ops.attention.attention_plain`; then
              o = bf16(f32(attn Wo) + bo), on x of width d and H heads of
              D (1 to 2,048) with W (d, H*D) and Wo (H*D, d): d = H*D in
              one process, and a tensor rank's H/T heads (d = 768, H = 6
              at UMD-B/4 over two) under the Megatron block
              K6 (`csrc/fused_mha.cu`): a wgmma GEMM with a bias
              epilogue for q, k, v, a wgmma max-shift attention core,
              the same GEMM for the out-projection; the scores and the
              probabilities never reach device memory.

Sums are f32 and each result is rounded once, where the unfused modules
round the product and the bias add separately. `fused_mlp` and `fused_mha`
run the plain versions for tensors on the CPU and the kernels for CUDA
tensors, and raise for a CUDA tensor a kernel does not take.

Both take bf16 and f32, as the TPU kernels are generic in the dtype
(`dtype_mm="float32"` runs them in f32, where every rounding above is the
identity). f32 inputs run the f32 instances (`csrc/fused_mlp_f32.cu`,
`csrc/fused_mha_f32.cu`: a SIMT GEMM in plain f32 FMA, no TF32, and K6's
attention the max-shift policy of `csrc/simt_f32_attention.cuh`), at every
width and head dim from 1 to 2,048 with nothing padded, and count under
`MLP_NAME_F32` / `MHA_NAME_F32`; what follows is of the bf16 kernels.

Both take every width, hidden width and H*D, as the JAX kernels do. The
kernels' GEMM takes any K and N that are multiples of 8 (TMA zero-fills
the tails: ViT-mu's width 32 and MLP 128 run as they are); the wrappers
launch them on zero-padded copies where a width is not a multiple of 8
(`pad_mlp`, `pad_mha`) or a head dim is not (`pad_mha` lays each head out
at the next multiple of 8, as `ops.attention.pad_heads`, and the
attention takes the true head dim's scale), and cut the output back. The
padded zeros add exact zeros to every sum, so the results are those at
the true widths.

Neither backward is a kernel, as in the JAX package: `FusedMLP` and
`FusedMHA` save their inputs and differentiate a reference composition
recomputed in the backward. The MLP's is the unfused Dense, gelu, Dense.
The attention's is three dense projections, `attention_packed` (so K3
recomputes the forward and K4 runs the backward: the clamped exp2 softmax,
not the max-shift one the forward used) and the out-projection. The
matmuls of these references lie outside any kernel and go to
`torch.matmul`.
"""

import functools

import torch

from small_vision_tpu_torch.ops import _build
from small_vision_tpu_torch.ops import attention as attn_lib

MLP_NAME = "fused_mlp_fwd"
MHA_NAME = "fused_mha_fwd"
# Launch counts of K5's and K6's f32 instances.
MLP_NAME_F32 = "fused_mlp_fwd_f32"
MHA_NAME_F32 = "fused_mha_fwd_f32"
# K5 and K6 take both.
FUSED_DTYPES = (torch.bfloat16, torch.float32)


def _f32(t):
  return t.to(torch.promote_types(t.dtype, torch.float32))


def fused_mlp_plain(x, w1, b1, w2, b2):
  """Plain PyTorch version of `_mlp_kernel`'s math."""
  h = torch.matmul(_f32(x), _f32(w1)) + _f32(b1)
  h = torch.nn.functional.gelu(h, approximate="tanh").to(x.dtype)
  return (torch.matmul(_f32(h), _f32(w2)) + _f32(b2)).to(x.dtype)


def fused_mha_plain(x, wq, bq, wk, bk, wv, bv, wo, bo, num_heads,
                    scale_dim=None):
  """Plain PyTorch version of `_mha_kernel`'s math, on x (B, L, d), q, k,
  v weights (d, H*hd) and an out-projection (H*hd, d). `scale_dim`: the
  head dim whose scale the scores take (by default hd; heads padded by
  `pad_mha` take their true one)."""
  b, l, _ = x.shape
  xf = _f32(x)
  proj = lambda w, bias: (torch.matmul(xf, _f32(w)) + _f32(bias)).to(
      x.dtype).reshape(b, l, num_heads, -1)
  a = attn_lib.attention_plain(proj(wq, bq), proj(wk, bk), proj(wv, bv),
                               scale_dim)
  a = a.reshape(b, l, -1)
  return (torch.matmul(_f32(a), _f32(wo)) + _f32(bo)).to(x.dtype)


def mlp_reference(x, w1, b1, w2, b2):
  """`_mlp_reference`: the unfused module, whose gradient `FusedMLP`
  takes. The first product is rounded before the bias add."""
  h = (torch.matmul(x, w1) + b1).to(torch.promote_types(x.dtype,
                                                        torch.float32))
  h = torch.nn.functional.gelu(h, approximate="tanh").to(x.dtype)
  return torch.matmul(h, w2) + b2


def mha_reference(x, wq, bq, wk, bk, wv, bv, wo, bo, num_heads):
  """`_mha_reference` through the packed attention, whose gradient
  `FusedMHA` takes."""
  q = torch.matmul(x, wq) + bq
  k = torch.matmul(x, wk) + bk
  v = torch.matmul(x, wv) + bv
  o = attn_lib.attention_packed(q, k, v, num_heads)
  return torch.matmul(o, wo) + bo


def _require(cond, msg, name):
  if not cond:
    raise ValueError(f"{name}: {msg}")


def _check_tensors(name, **tensors):
  """Each of `tensors` ({name: (tensor, shape)}) a contiguous tensor of its
  shape on the first one's device and of its dtype, bf16 or f32; a bf16
  one at a 16-byte aligned address (the bf16 kernels' TMA bases)."""
  first = next(iter(tensors.values()))[0]
  dtype, device = first.dtype, first.device
  what = " or ".join(str(d).replace("torch.", "") for d in FUSED_DTYPES)
  _require(dtype in FUSED_DTYPES,
           f"{next(iter(tensors))} must be {what}, got {dtype}", name)
  bf16 = dtype == torch.bfloat16
  for n, (t, shape) in tensors.items():
    _require(t.device == device and t.dtype == dtype
             and tuple(t.shape) == shape and t.is_contiguous()
             and (not bf16 or t.data_ptr() % 16 == 0),
             f"{n} must be a contiguous{', 16-byte aligned' if bf16 else ''} "
             f"{str(dtype).replace('torch.', '')} {shape} on {device}, got "
             f"{t.dtype} {tuple(t.shape)}", name)


# K5's and K6's GEMM takes widths that are multiples of this (a TMA row
# stride is a multiple of 16 bytes); the wrappers pad the others.
GEMM_MULTIPLE = 8


def _round_up(n):
  return -(-n // GEMM_MULTIPLE) * GEMM_MULTIPLE


def pad_cols(t, n):
  """`t` with its last axis zero-padded to `n` columns, as a new contiguous
  tensor; `t` itself where it has `n`."""
  if t.shape[-1] == n:
    return t
  return torch.nn.functional.pad(t, (0, n - t.shape[-1]))


def pad_rows(w, n):
  """The matrix `w` with zero rows appended up to `n`, as a new contiguous
  tensor; `w` itself where it has `n`."""
  if w.shape[0] == n:
    return w
  return torch.nn.functional.pad(w, (0, 0, 0, n - w.shape[0]))


def unpad_cols(t, n):
  """The first `n` columns of `t`'s last axis, contiguous; `t` itself
  where it has `n`."""
  return t if t.shape[-1] == n else t[..., :n].contiguous()


def pad_mlp(x, w1, b1, w2, b2):
  """K5's operands at the width d and hidden width rounded up to multiples
  of 8: x's columns, W1's rows and columns, b1, W2's rows and columns and
  b2 zero-padded (the arguments themselves where both are multiples of 8).
  Exact: a padded column of x meets a zero row of W1, a padded hidden unit
  is gelu(0 + 0) = 0 and meets a zero row of W2, and the padded output
  columns are cut off (`unpad_cols(y, d)`). The copies read x and the
  weights once and write them at the padded widths, and cut y once more:
  a few passes over x's bytes, at widths no configuration reaches."""
  d, hidden = w1.shape
  dp, hp = _round_up(d), _round_up(hidden)
  return (pad_cols(x, dp), pad_cols(pad_rows(w1, dp), hp), pad_cols(b1, hp),
          pad_cols(pad_rows(w2, hp), dp), pad_cols(b2, dp))


def pad_mha(x, wq, bq, wk, bk, wv, bv, wo, bo, num_heads):
  """K6's operands at the width d rounded up to a multiple of 8 and with
  each head laid out at `ops.attention.padded_head_dim` of its head dim
  (the arguments themselves where neither needs it): x's columns, the
  rows of wq, wk, wv and the columns of wo and bo zero-padded to the
  width; each head's columns of wq, wk, wv, bq, bk, bv and its rows of wo
  zero-padded to the head dim. Exact, with the attention at the true head
  dim's scale: the padded columns of q and k add zeros to every score,
  those of v give head outputs that meet zero rows of wo, and the padded
  output columns are cut off (`unpad_cols(o, d)`). Only the weights are
  copied where d is a multiple of 8: at `heads=32` on UMD-S (width 384,
  head dim 12 run at 16) four 384 x 512 matrices, 1.5 MB a call."""
  d = x.shape[-1]
  hd = wq.shape[-1]
  head_dim = hd // num_heads
  dm, dp = _round_up(d), attn_lib.padded_head_dim(head_dim)
  heads = lambda t: attn_lib.pad_heads(t, num_heads, dp)
  if dp != head_dim:
    wo = torch.nn.functional.pad(wo.reshape(num_heads, head_dim, -1),
                                 (0, 0, 0, dp - head_dim))
    wo = wo.reshape(num_heads * dp, -1)
  return (pad_cols(x, dm), *(t for w, b in ((wq, bq), (wk, bk), (wv, bv))
                             for t in (heads(pad_rows(w, dm)), heads(b))),
          pad_cols(wo, dm), pad_cols(bo, dm))


@functools.cache
def _mlp_lib(f32=False):
  return _build.library("fused_mlp_f32" if f32 else "fused_mlp")


@functools.cache
def _mha_lib(f32=False):
  return _build.library("fused_mha_f32" if f32 else "fused_mha")


def check_mlp(x, w1, b1, w2, b2):
  """(rows, width) once the arguments are what K5 takes: bf16 or f32, any
  width and hidden width (for bf16 `pad_mlp` pads them to multiples of 8).
  Needs no card: the tests run it on CPU tensors."""
  d, hidden = x.shape[-1], w1.shape[-1]
  _require(d > 0, f"width {d}: the kernel takes widths from 1", MLP_NAME)
  _require(hidden > 0, f"hidden width {hidden}: the kernel takes widths "
           "from 1", MLP_NAME)
  _check_tensors(MLP_NAME, x=(x, tuple(x.shape)), w1=(w1, (d, hidden)),
                 b1=(b1, (hidden,)), w2=(w2, (hidden, d)), b2=(b2, (d,)))
  return x.numel() // d, d


def mlp_operands(x, w1, b1, w2, b2):
  """The operands K5 launches on: `pad_mlp`'s for bf16, the arguments
  themselves for f32 (the f32 GEMM takes every width)."""
  if x.dtype == torch.float32:
    return x, w1, b1, w2, b2
  return pad_mlp(x, w1, b1, w2, b2)


def _mlp_checked(x, w1, b1, w2, b2):
  """(library, rows, width) once the arguments are what K5 takes
  (`check_mlp`) on the card: the f32 instance's library for f32."""
  _require(x.is_cuda, "x must be a CUDA tensor", MLP_NAME)
  rows, d = check_mlp(x, w1, b1, w2, b2)
  return _mlp_lib(x.dtype == torch.float32), rows, d


def fused_mlp_fwd(x, w1, b1, w2, b2):
  """Launches K5 on bf16 or f32 contiguous x (..., D), w1 (D, hidden), b1
  (hidden,), w2 (hidden, D), b2 (D,), any D and hidden (bf16 on copies
  padded to multiples of 8 where they are not, `pad_mlp`; f32 as they
  are): the up-projection with gelu into a (rows, hidden) scratch of x's
  dtype, then the down-projection, two kernel launches. Sums run in a
  fixed order (no atomics), so two launches give the same bits. f32
  launches count under MLP_NAME_F32."""
  lib, rows, d = _mlp_checked(x, w1, b1, w2, b2)
  if rows == 0:
    return torch.empty_like(x)
  f32 = x.dtype == torch.float32
  x, w1, b1, w2, b2 = mlp_operands(x, w1, b1, w2, b2)
  dp, hidden = w1.shape
  h = torch.empty(rows, hidden, dtype=x.dtype, device=x.device)
  y = torch.empty_like(x)
  _build.launch(MLP_NAME, x.device,
                lib.fused_mlp_f32_fwd if f32 else lib.fused_mlp_fwd,
                *(t.data_ptr() for t in (x, w1, b1, w2, b2, h, y)), rows, dp,
                hidden)
  _build.LAUNCHES[MLP_NAME_F32 if f32 else MLP_NAME] += 1
  return unpad_cols(y, d)


def fused_mlp_stages(x, w1, b1, w2, b2):
  """K5's two launches one by one, to time each: {"up", "down": a function
  that launches that kernel}, on buffers made here (the down-projection
  reads the h the first one wrote), at the padded widths where `pad_mlp`
  pads (bf16). For measurement only: they count no launch."""
  lib, rows, _ = _mlp_checked(x, w1, b1, w2, b2)
  pre = "fused_mlp_f32" if x.dtype == torch.float32 else "fused_mlp"
  x, w1, b1, w2, b2 = mlp_operands(x, w1, b1, w2, b2)
  d, hidden = w1.shape
  h = torch.empty(rows, hidden, dtype=x.dtype, device=x.device)
  y = torch.empty_like(x)
  ptr = lambda *ts: [t.data_ptr() for t in ts]
  return {
      "up": lambda: _build.launch(MLP_NAME, x.device,
                                  getattr(lib, f"{pre}_up"),
                                  *ptr(x, w1, b1, h), rows, d, hidden),
      "down": lambda: _build.launch(MLP_NAME, x.device,
                                    getattr(lib, f"{pre}_down"),
                                    *ptr(h, w2, b2, y), rows, d, hidden),
  }


def check_mha(x, wq, bq, wk, bk, wv, bv, wo, bo, num_heads):
  """(b, l, d, head_dim) once the arguments are what K6 takes, but for
  the length limit: x (B, L, d), q, k, v weights (d, hd) and biases (hd,),
  the out-projection (hd, d) and its bias (d,), hd = num_heads *
  head_dim, bf16 or f32, the head dim from 1 to 2,048, any d (for bf16
  `pad_mha` pads the widths and head dims the kernels' tiles do not take).
  Needs no card: the tests run it on CPU tensors."""
  _require(x.dim() == 3, f"x must be (B, L, d), got {tuple(x.shape)}",
           MHA_NAME)
  b, l, d = x.shape
  hd = wq.shape[-1]
  _require(num_heads > 0 and hd % num_heads == 0,
           f"projections of {hd} columns are not num_heads {num_heads} "
           "heads", MHA_NAME)
  head_dim = hd // num_heads
  attn_lib.check_head_dim(head_dim, MHA_NAME)
  _require(d > 0, f"width {d}: the kernel takes widths from 1", MHA_NAME)
  mats = {n: (t, (d, hd)) for n, t in (("wq", wq), ("wk", wk), ("wv", wv))}
  vecs = {n: (t, (hd,)) for n, t in (("bq", bq), ("bk", bk), ("bv", bv))}
  _check_tensors(MHA_NAME, x=(x, (b, l, d)), **mats, **vecs,
                 wo=(wo, (hd, d)), bo=(bo, (d,)))
  return b, l, d, head_dim


def mha_operands(x, wq, bq, wk, bk, wv, bv, wo, bo, num_heads):
  """The operands K6 launches on: `pad_mha`'s for bf16, the arguments
  themselves for f32 (its GEMM and attention take every width and head
  dim)."""
  args = (x, wq, bq, wk, bk, wv, bv, wo, bo)
  if x.dtype == torch.float32:
    return args
  return pad_mha(*args, num_heads)


def _mha_checked(x, wq, bq, wk, bk, wv, bv, wo, bo, num_heads):
  """(library, (b, l, d, head_dim)) once the arguments are what K6 takes
  (`check_mha`, and L up to `fused_mha_max_len`) on the card: the f32
  instance's library for f32."""
  _require(x.is_cuda, "x must be a CUDA tensor", MHA_NAME)
  b, l, d, head_dim = check_mha(x, wq, bq, wk, bk, wv, bv, wo, bo,
                                num_heads)
  f32 = x.dtype == torch.float32
  max_len = fused_mha_max_len(head_dim, f32)
  _require(l <= max_len, f"sequence length {l} > {max_len} at head dim "
           f"{head_dim}", MHA_NAME)
  return _mha_lib(f32), (b, l, d, head_dim)


def fused_mha_max_len(head_dim: int, f32: bool = False) -> int:
  """The longest sequence K6 takes at a head dim (builds the kernels):
  4,096 at every one (its attention's K and V stream through a ring of
  stages past 320 keys at head dims up to 64 and 384 up to 128, and at
  every length above); a head dim that is not a multiple of 8 runs at the
  next one. `f32`: that of the f32 instance, 4,096 at every head dim."""
  if f32:
    return _mha_lib(True).fused_mha_f32_max_len()
  return _mha_lib().fused_mha_max_len(attn_lib.padded_head_dim(head_dim))


def fused_mha_fwd(x, wq, bq, wk, bk, wv, bv, wo, bo, num_heads):
  """Launches K6 on bf16 or f32 contiguous x (B, L, d), three (d, H*D)
  weights with (H*D,) biases and the (H*D, d) out-projection with its (d,)
  bias, D from 1 to 2,048, any d (d = H*D in one process; a tensor rank's H
  heads of a wider model under the Megatron block; bf16 on copies padded
  by `pad_mha` where d or D is not a multiple of 8, f32 as they are): the
  q, k, v projection, the attention (at the true head dim's scale) and the
  out-projection, three kernel launches through q, k, v and head outputs
  in device memory. L up to `fused_mha_max_len`, 4,096. Sums run in a
  fixed order (no atomics), so two launches give the same bits. f32
  launches count under MHA_NAME_F32."""
  lib, (b, l, d, head_dim) = _mha_checked(x, wq, bq, wk, bk, wv, bv, wo, bo,
                                          num_heads)
  if x.numel() == 0:
    return torch.empty_like(x)
  f32 = x.dtype == torch.float32
  x, *params = mha_operands(x, wq, bq, wk, bk, wv, bv, wo, bo, num_heads)
  dm, hd = x.shape[-1], params[0].shape[-1]
  qkv = torch.empty(b, l, 3 * hd, dtype=x.dtype, device=x.device)
  heads_out = torch.empty(b, l, hd, dtype=x.dtype, device=x.device)
  o = torch.empty_like(x)
  _build.launch(MHA_NAME, x.device,
                lib.fused_mha_f32_fwd if f32 else lib.fused_mha_fwd,
                *(t.data_ptr() for t in (x, *params, qkv, heads_out, o)),
                b, l, dm, num_heads, hd // num_heads,
                (attn_lib.scale_log2 if f32 else attn_lib.scale_f32)(
                    head_dim))
  _build.LAUNCHES[MHA_NAME_F32 if f32 else MHA_NAME] += 1
  return unpad_cols(o, d)


def fused_mha_stages(x, wq, bq, wk, bk, wv, bv, wo, bo, num_heads):
  """K6's three launches one by one, to time each: {"qkv_proj",
  "attention", "out_proj": a function that launches that kernel}, on
  buffers made here (the attention reads the q, k, v the first one
  wrote), at the padded widths where `pad_mha` pads (bf16). For
  measurement only: they count no launch."""
  lib, (b, l, _, head_dim) = _mha_checked(x, wq, bq, wk, bk, wv, bv, wo, bo,
                                          num_heads)
  f32 = x.dtype == torch.float32
  pre = "fused_mha_f32" if f32 else "fused_mha"
  scale = (attn_lib.scale_log2 if f32 else attn_lib.scale_f32)(head_dim)
  x, wq, bq, wk, bk, wv, bv, wo, bo = mha_operands(
      x, wq, bq, wk, bk, wv, bv, wo, bo, num_heads)
  d, hd = x.shape[-1], wq.shape[-1]
  qkv = torch.empty(b, l, 3 * hd, dtype=x.dtype, device=x.device)
  heads_out = torch.empty(b, l, hd, dtype=x.dtype, device=x.device)
  o = torch.empty_like(x)
  ptr = lambda *ts: [t.data_ptr() for t in ts]
  launch = lambda entry, *args: _build.launch(MHA_NAME, x.device, entry,
                                              *args)
  return {
      "qkv_proj": lambda: launch(getattr(lib, f"{pre}_proj"),
                                 *ptr(x, wq, wk, wv, bq, bk, bv, qkv),
                                 b * l, hd, d, 3),
      "attention": lambda: launch(getattr(lib, f"{pre}_attention"),
                                  qkv.data_ptr(), heads_out.data_ptr(), b,
                                  l, num_heads, hd // num_heads, scale),
      "out_proj": lambda: launch(getattr(lib, f"{pre}_proj"),
                                 *ptr(heads_out, wo, wo, wo, bo, bo, bo, o),
                                 b * l, d, hd, 1),
  }


def _reference_grads(ctx, reference, g, *static):
  """Gradients of `reference(*saved, *static)` for the saved inputs that
  need one, recomputed with gradients enabled."""
  saved = ctx.saved_tensors  # once: a checkpoint's tensors unpack once
  needs = ctx.needs_input_grad[:len(saved)]
  with torch.enable_grad():
    args = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
    out = reference(*args, *static)
    grads = iter(torch.autograd.grad(
        out, [a for a, n in zip(args, needs) if n], g))
  return tuple(next(grads) if n else None for n in needs)


class FusedMLP(torch.autograd.Function):
  """Differentiable `fused_mlp`: K5 (the plain version on CPU tensors)
  forward; the backward is the gradient of `mlp_reference`."""

  @staticmethod
  def forward(ctx, x, w1, b1, w2, b2):
    ctx.save_for_backward(x, w1, b1, w2, b2)
    if x.device.type == "cpu":
      return fused_mlp_plain(x, w1, b1, w2, b2)
    return fused_mlp_fwd(x, w1, b1, w2, b2)

  @staticmethod
  def backward(ctx, g):
    return _reference_grads(ctx, mlp_reference, g)


class FusedMHA(torch.autograd.Function):
  """Differentiable `fused_mha`: K6 (the plain version on CPU tensors)
  forward; the backward is the gradient of `mha_reference`, which runs the
  packed attention's forward (K3) and backward (K4)."""

  @staticmethod
  def forward(ctx, x, wq, bq, wk, bk, wv, bv, wo, bo, num_heads):
    ctx.num_heads = num_heads
    ctx.save_for_backward(x, wq, bq, wk, bk, wv, bv, wo, bo)
    if x.device.type == "cpu":
      return fused_mha_plain(x, wq, bq, wk, bk, wv, bv, wo, bo, num_heads)
    return fused_mha_fwd(x, wq, bq, wk, bk, wv, bv, wo, bo, num_heads)

  @staticmethod
  def backward(ctx, g):
    return (*_reference_grads(ctx, mha_reference, g, ctx.num_heads), None)


def _wants_grad(tensors):
  return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# K5's and K6's forwards as operators that `torch.export` sees (the
# exported sampler, `tools/export_sampler.py`): CUDA is the wrapper, CPU
# the plain version; eager code calls the wrappers themselves.
@torch.library.custom_op("svt::fused_mlp_fwd", mutates_args=(),
                         device_types="cuda")
def _fused_mlp_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
  return fused_mlp_fwd(x, w1, b1, w2, b2)


@_fused_mlp_op.register_kernel("cpu")
def _(x, w1, b1, w2, b2):
  return fused_mlp_plain(x, w1, b1, w2, b2)


@_fused_mlp_op.register_fake
def _(x, w1, b1, w2, b2):
  return torch.empty_like(x)


@torch.library.custom_op("svt::fused_mha_fwd", mutates_args=(),
                         device_types="cuda")
def _fused_mha_op(x: torch.Tensor, wq: torch.Tensor, bq: torch.Tensor,
                  wk: torch.Tensor, bk: torch.Tensor, wv: torch.Tensor,
                  bv: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                  num_heads: int) -> torch.Tensor:
  return fused_mha_fwd(x, wq, bq, wk, bk, wv, bv, wo, bo, num_heads)


@_fused_mha_op.register_kernel("cpu")
def _(x, wq, bq, wk, bk, wv, bv, wo, bo, num_heads):
  return fused_mha_plain(x, wq, bq, wk, bk, wv, bv, wo, bo, num_heads)


@_fused_mha_op.register_fake
def _(x, wq, bq, wk, bk, wv, bv, wo, bo, num_heads):
  return torch.empty_like(x)


def fused_mlp(x, w1, b1, w2, b2):
  """Dense, tanh-gelu, Dense on (..., D): the plain version on CPU tensors,
  K5 on CUDA tensors; differentiable through `FusedMLP`; the operator
  `svt::fused_mlp_fwd` under `torch.export`."""
  args = (x, w1, b1, w2, b2)
  if _wants_grad(args):
    return FusedMLP.apply(*args)
  if torch.compiler.is_exporting():
    return _fused_mlp_op(*args)
  if x.device.type == "cpu":
    return fused_mlp_plain(*args)
  return fused_mlp_fwd(*args)


def fused_mha(x, wq, bq, wk, bk, wv, bv, wo, bo, num_heads):
  """Self-attention with its four projections on packed (B, L, H*D): the
  plain version on CPU tensors, K6 on CUDA tensors; differentiable through
  `FusedMHA`; the operator `svt::fused_mha_fwd` under `torch.export`."""
  args = (x, wq, bq, wk, bk, wv, bv, wo, bo)
  if _wants_grad(args):
    return FusedMHA.apply(*args, num_heads)
  if torch.compiler.is_exporting():
    return _fused_mha_op(*args, int(num_heads))
  if x.device.type == "cpu":
    return fused_mha_plain(*args, num_heads)
  return fused_mha_fwd(*args, num_heads)
