"""Port parity: the fused MLP and fused MHA (the plain versions of K5 and
K6, and their reference-composition backwards), and the model under
`attn_impl="pallas_fused"`.

The same inputs, drawn with numpy, go through the JAX package's
`fused_mlp` / `fused_mha` with their Pallas kernels in interpret mode (as
tests/test_fused_block.py runs them) and through the port on the CPU. The
gradients are held against `jax.grad` of the fused functions, whose custom
VJP differentiates the reference composition (the packed attention's
clamped softmax, not the forward's max-shift one). A `Block` and the whole
`_ViTAE` run on bridged weights against `attn_impl="pallas_fused_interpret"`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_vision_tpu.models import ae as jae
from small_vision_tpu.models import vit as jvit
from small_vision_tpu.ops import fused_block as jfb
from small_vision_tpu_torch import convert
from small_vision_tpu_torch.configs import ae_i1k
from small_vision_tpu_torch.models import vit as tvit
from small_vision_tpu_torch.ops import _build
from small_vision_tpu_torch.ops import fused_block as tfb
from small_vision_tpu_torch.train import train_ae
from small_vision_tpu_torch.utils.trees import tree_flatten_with_names

B, D, DH = 4, 128, 512
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _mlp_args(l, seed=0, d=D, dh=DH, b=B):
  rng = np.random.default_rng(seed)
  n = lambda *s: rng.standard_normal(s).astype(np.float32)
  return (n(b, l, d), n(d, dh) * 0.08, n(dh) * 0.02, n(dh, d) * 0.08,
          n(d) * 0.02)


def _mha_args(l, heads=2, seed=0, head_dim=64):
  rng = np.random.default_rng(seed)
  d = heads * head_dim
  n = lambda *s: rng.standard_normal(s).astype(np.float32)
  args = [n(B, l, d)]
  for _ in range(4):
    args += [n(d, d) * 0.08, n(d) * 0.02]
  return tuple(args)


def _jax(args, dtype):
  return [jnp.asarray(a, dtype) for a in args]


def _torch(args, dtype, grad=False):
  return [torch.from_numpy(a).to(dtype).requires_grad_(grad) for a in args]


def _np(a):
  if isinstance(a, torch.Tensor):
    return a.detach().float().numpy()
  return np.asarray(a.astype(jnp.float32))


# bf16: both sides round the hidden activations (or q, k, v, the
# probabilities and the head outputs) and the output to bf16; f32 sums in
# another order may flip one of the inner roundings, which moves an output
# by about one bf16 ulp of the largest values (the spacing of bf16 values
# is 2^-8 to 2^-7 of their magnitude): 2^-6 of the output's max, two ulps.
def _assert_bf16_close(got, want):
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=2.0**-6 * np.max(np.abs(want)))


@pytest.mark.parametrize("l", [16, 37])
def test_fused_mlp_matches_jax_f32(l):
  args = _mlp_args(l)
  want = jfb.fused_mlp(*_jax(args, jnp.float32), True)
  got = tfb.fused_mlp(*_torch(args, torch.float32))
  np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("l", [16, 37])
def test_fused_mlp_matches_jax_bf16(l):
  args = _mlp_args(l, seed=1)
  want = jfb.fused_mlp(*_jax(args, jnp.bfloat16), True)
  got = tfb.fused_mlp(*_torch(args, torch.bfloat16))
  assert got.dtype == torch.bfloat16
  _assert_bf16_close(_np(got), _np(want))


def test_fused_mlp_matches_jax_bf16_at_the_model_width():
  """UMD-B's MLP (width 768, hidden 3,072) against the JAX kernel in
  interpret mode, at L=16: the JAX kernel keeps both weights (9.4 MB) in
  its 11 MiB VMEM budget (`_pick_bb`), which leaves room for the rows of
  L=16 and of no length past 48."""
  args = _mlp_args(16, seed=5, d=768, dh=3072, b=2)
  want = jfb.fused_mlp(*_jax(args, jnp.bfloat16), True)
  got = tfb.fused_mlp(*_torch(args, torch.bfloat16))
  _assert_bf16_close(_np(got), _np(want))


def _mlp_kernel_math(x, w1, b1, w2, b2):
  """The body of the JAX `_mlp_kernel`, in jnp outside Pallas."""
  h = jnp.dot(x, w1, preferred_element_type=jnp.float32) + b1
  h = jax.nn.gelu(h).astype(x.dtype)
  return (jnp.dot(h, w2, preferred_element_type=jnp.float32)
          + b2).astype(x.dtype)


@pytest.mark.parametrize("l,d,dh", [(68, 768, 3072), (16, 1024, 4096)])
def test_fused_mlp_matches_the_jax_kernel_math_where_the_kernel_refuses(
    l, d, dh):
  """The main path's MLP shapes that the JAX kernel refuses: its VMEM
  budget (`_pick_bb`, 11 MiB) holds the weights and the rows of width 768
  only up to L=48 (the MAE encoder runs at L=68), and not the weights of
  width 1,024 (UMD-L/2) at all. The port computes the same function
  there; it is held against the kernel's own arithmetic."""
  args = _mlp_args(l, seed=6, d=d, dh=dh, b=2)
  jargs = _jax(args, jnp.bfloat16)
  with pytest.raises(ValueError, match="cannot fit in VMEM"):
    jfb.fused_mlp(*jargs, True)
  want = _mlp_kernel_math(*jargs)
  got = tfb.fused_mlp(*_torch(args, torch.bfloat16))
  _assert_bf16_close(_np(got), _np(want))


@pytest.mark.parametrize("l,heads", [(16, 2), (37, 2), (37, 3)])
def test_fused_mha_matches_jax_f32(l, heads):
  args = _mha_args(l, heads)
  want = jfb.fused_mha(*_jax(args, jnp.float32), heads, True)
  got = tfb.fused_mha(*_torch(args, torch.float32), heads)
  np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("l,heads", [(16, 2), (37, 2), (37, 3)])
def test_fused_mha_matches_jax_bf16(l, heads):
  args = _mha_args(l, heads, seed=1)
  want = jfb.fused_mha(*_jax(args, jnp.bfloat16), heads, True)
  got = tfb.fused_mha(*_torch(args, torch.bfloat16), heads)
  assert got.dtype == torch.bfloat16
  _assert_bf16_close(_np(got), _np(want))


# Widths the card's GEMM once refused (multiples of 64 only): ViT-mu's
# MLP, 32 -> 128 (one zero-filled half stage of 64), and a hidden width
# that is a multiple of 8 but not of 64, 40 -> 176; and one that the
# wrapper pads, 36 -> 150 (run at 40 -> 152).
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,dh", [(32, 128), (36, 150), (40, 176)])
def test_fused_mlp_matches_jax_at_any_width(d, dh, dtype):
  """K5's plain version against the interpreted JAX kernel, which takes
  any width, with the bounds of the tests above."""
  args = _mlp_args(23, seed=d, d=d, dh=dh, b=2)
  jdt, tdt = DTYPES[dtype]
  want = jfb.fused_mlp(*_jax(args, jdt), True)
  got = tfb.fused_mlp(*_torch(args, tdt))
  assert got.dtype == tdt and got.shape == (2, 23, d)
  if dtype == "float32":
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)
  else:
    _assert_bf16_close(_np(got), _np(want))


# K6 at ViT-mu's width 32 in 2 heads of 16 (H*D = 32, under one 64-column
# tile), at 36 in 3 heads of 12 (the width and the head dim padded: 40, 3
# heads of 16) and at 40 in 5 heads of 8.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads,head_dim", [(2, 16), (3, 12), (5, 8)])
def test_fused_mha_matches_jax_at_any_width(heads, head_dim, dtype):
  """K6's plain version against the interpreted JAX kernel (any width,
  any head dim), with the bounds of the tests above."""
  args = _mha_args(21, heads, seed=head_dim, head_dim=head_dim)
  jdt, tdt = DTYPES[dtype]
  want = jfb.fused_mha(*_jax(args, jdt), heads, True)
  got = tfb.fused_mha(*_torch(args, tdt), heads)
  assert got.dtype == tdt and got.shape == args[0].shape
  if dtype == "float32":
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)
  else:
    _assert_bf16_close(_np(got), _np(want))


def _f64(args):
  return [torch.from_numpy(a).double() for a in args]


@pytest.mark.parametrize("d,dh", [(36, 150), (40, 176), (30, 7)])
def test_padded_mlp_gives_the_plain_version_at_the_true_widths(d, dh):
  """What `fused_mlp_fwd` launches where a width is not a multiple of 8:
  K5's arithmetic on `pad_mlp`'s copies, y cut back. Through the plain
  version in f64 it equals the plain version at the true widths within
  1e-12 of the largest output (the zeros add exact zeros; a BLAS may
  order a sum of another length otherwise). At multiples of 8 the
  operands are the arguments themselves."""
  args = _f64(_mlp_args(9, seed=d, d=d, dh=dh, b=2))
  padded = tfb.pad_mlp(*args)
  assert [tuple(t.shape) for t in padded] == [
      (2, 9, -(-d // 8) * 8), (-(-d // 8) * 8, -(-dh // 8) * 8),
      (-(-dh // 8) * 8,), (-(-dh // 8) * 8, -(-d // 8) * 8),
      (-(-d // 8) * 8,)]
  want = tfb.fused_mlp_plain(*args)
  got = tfb.unpad_cols(tfb.fused_mlp_plain(*padded), d)
  assert got.shape == want.shape
  assert (got - want).abs().max().item() <= 1e-12 * want.abs().max().item()
  whole = _f64(_mlp_args(9, d=32, dh=128, b=2))
  assert all(p is a for p, a in zip(tfb.pad_mlp(*whole), whole))


@pytest.mark.parametrize("heads,head_dim,width", [
    (32, 12, 384),  # heads=32 at UMD-S: 32 heads of 12 run at 16
    (3, 12, 36), (5, 6, 30),  # the width padded too
    (3, 32, 384)])  # a tensor rank's 3 of 12 heads of 32: 96 columns
def test_padded_mha_gives_the_plain_version_at_the_true_widths(
    heads, head_dim, width):
  """What `fused_mha_fwd` launches where the width or the head dim is not
  a multiple of 8: K6's arithmetic on `pad_mha`'s copies at the padded
  head dim with the true head dim's scale, o cut back. Through the plain
  version in f64 it equals the plain version at the true shapes within
  1e-12 of the largest output."""
  rng = np.random.default_rng(heads + head_dim)
  hd = heads * head_dim
  n = lambda *s, std=1.0: torch.from_numpy(rng.standard_normal(s) * std)
  args = [n(2, 11, width)]
  for _ in range(3):
    args += [n(width, hd, std=width**-0.5), n(hd, std=0.1)]
  args += [n(hd, width, std=hd**-0.5), n(width, std=0.1)]
  padded = tfb.pad_mha(*args, heads)
  dm = -(-width // 8) * 8
  dp = -(-head_dim // 8) * 8
  assert padded[0].shape == (2, 11, dm)
  assert padded[1].shape == (dm, heads * dp) and padded[2].shape == (
      heads * dp,)
  assert padded[7].shape == (heads * dp, dm) and padded[8].shape == (dm,)
  if (dm, dp) == (width, head_dim):
    assert all(p is a for p, a in zip(padded, args))
  want = tfb.fused_mha_plain(*args, heads)
  got = tfb.unpad_cols(tfb.fused_mha_plain(*padded, heads,
                                           scale_dim=head_dim), width)
  assert got.shape == want.shape
  assert (got - want).abs().max().item() <= 1e-12 * want.abs().max().item()


def _mha_kernel_math(x, wq, bq, wk, bk, wv, bv, wo, bo, num_heads):
  """The body of the JAX `_mha_kernel`, in jnp outside Pallas, over the
  whole batch."""
  f32 = jnp.float32
  dot = lambda a, w: jnp.dot(a, w, preferred_element_type=f32)
  q, k, v = ((dot(x, w) + bias).astype(x.dtype)
             for w, bias in ((wq, bq), (wk, bk), (wv, bv)))
  d = q.shape[-1] // num_heads
  heads = []
  for h in range(num_heads):
    sl = slice(h * d, (h + 1) * d)
    scores = jnp.einsum("bqd,bkd->bqk", q[..., sl], k[..., sl],
                        preferred_element_type=f32) * (1.0 / np.sqrt(d))
    e = jnp.exp(scores - jnp.max(scores, axis=-1, keepdims=True))
    probs = (e / jnp.sum(e, axis=-1, keepdims=True)).astype(x.dtype)
    heads.append(jnp.einsum("bqk,bkd->bqd", probs, v[..., sl],
                            preferred_element_type=f32).astype(x.dtype))
  attn = jnp.concatenate(heads, axis=-1)
  return (dot(attn, wo) + bo).astype(x.dtype)


# ViT-L/16@512's lengths (1,024 "map", 1,025 "tok") at head dim 64 and
# ViT-H/14@518's (1,369) at 80, two heads: the card's K6 streams K and V
# there.
@pytest.mark.parametrize("l,head_dim", [(1024, 64), (1025, 64), (1369, 80)])
def test_fused_mha_matches_the_jax_kernel_math_where_the_kernel_refuses(
    l, head_dim):
  """Lengths past about 950 that the JAX kernel refuses at every width:
  its VMEM budget (`_pick_bb`, 11 MiB) must hold the (Lp, Lp) f32 scores
  of a row. The port computes the same function there (as K5 and K6 do at
  ViT-H's width); it is held against the kernel's own arithmetic."""
  rng = np.random.default_rng(l)
  d = 2 * head_dim
  n = lambda *s: rng.standard_normal(s).astype(np.float32)
  args = [n(2, l, d)]
  for _ in range(4):
    args += [n(d, d) * 0.08, n(d) * 0.02]
  jargs = _jax(args, jnp.bfloat16)
  with pytest.raises(ValueError, match="cannot fit in VMEM"):
    jfb.fused_mha(*jargs, 2, True)
  want = _mha_kernel_math(*jargs, 2)
  got = tfb.fused_mha(*_torch(args, torch.bfloat16), 2)
  assert got.dtype == torch.bfloat16 and got.shape == (2, l, d)
  _assert_bf16_close(_np(got), _np(want))


def _grads_match(jax_fn, torch_fn, args, l, d):
  co = np.random.default_rng(9).standard_normal((B, l, d)).astype(np.float32)
  want = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * co),
                  argnums=tuple(range(len(args))))(*_jax(args, jnp.float32))
  targs = _torch(args, torch.float32, grad=True)
  torch_fn(*targs).backward(torch.from_numpy(co))
  for i, (t, w) in enumerate(zip(targs, want)):
    # The same f32 formulas of the reference composition; the products and
    # the softmax sums run in another order.
    np.testing.assert_allclose(_np(t.grad), _np(w), rtol=5e-4, atol=5e-4,
                               err_msg=f"argument {i}")


def test_fused_mlp_grads_match_jax():
  l = 24
  _grads_match(lambda *a: jfb.fused_mlp(*a, True), tfb.fused_mlp,
               _mlp_args(l, seed=2), l, D)


@pytest.mark.parametrize("heads", [2, 3])
def test_fused_mha_grads_match_jax(heads):
  l = 37
  _grads_match(lambda *a: jfb.fused_mha(*a, heads, True),
               lambda *a: tfb.fused_mha(*a, heads),
               _mha_args(l, heads, seed=2), l, heads * 64)


def test_fused_mha_bf16_gradients_keep_their_dtypes():
  targs = _torch(_mha_args(20, seed=3), torch.bfloat16, grad=True)
  tfb.fused_mha(*targs, 2).float().sum().backward()
  for t in targs:
    assert t.grad.dtype == torch.bfloat16 and t.grad.shape == t.shape
    assert torch.isfinite(t.grad.float()).all()


def test_backward_differentiates_the_reference_not_the_forward():
  """With logits past the packed attention's ±80 clamp the max-shift
  forward and the clamped reference differ; the gradient is the
  reference's, as in the JAX custom VJP."""
  args = list(_mha_args(16, seed=4))
  args[1] = args[1] * 60.0  # wq: large queries
  args[3] = args[3] * 60.0  # wk: large keys
  targs = _torch(args, torch.float32, grad=True)
  tfb.fused_mha(*targs, 2).sum().backward()
  rargs = _torch(args, torch.float32, grad=True)
  tfb.mha_reference(*rargs, 2).sum().backward()
  for t, r in zip(targs, rargs):
    torch.testing.assert_close(t.grad, r.grad, rtol=1e-5, atol=1e-6)
  pargs = _torch(args, torch.float32, grad=True)
  tfb.fused_mha_plain(*pargs, 2).sum().backward()
  assert not torch.allclose(targs[0].grad, pargs[0].grad, rtol=1e-2,
                            atol=1e-3)


def test_no_grad_takes_the_forward_only_and_counts_no_launch():
  before = dict(_build.LAUNCHES)
  targs = _torch(_mlp_args(16), torch.float32, grad=True)
  with torch.no_grad():
    assert tfb.fused_mlp(*targs).grad_fn is None
  assert type(tfb.fused_mlp(*targs).grad_fn).__name__ == "FusedMLPBackward"
  margs = _torch(_mha_args(16), torch.float32, grad=True)
  assert type(tfb.fused_mha(*margs, 2).grad_fn).__name__ == \
      "FusedMHABackward"
  assert dict(_build.LAUNCHES) == before  # CPU tensors: plain versions


def test_kernel_wrappers_refuse_cpu_tensors():
  with pytest.raises(ValueError, match="CUDA tensor"):
    tfb.fused_mlp_fwd(*_torch(_mlp_args(16), torch.bfloat16))
  with pytest.raises(ValueError, match="CUDA tensor"):
    tfb.fused_mha_fwd(*_torch(_mha_args(16), torch.bfloat16), 2)


# ---------------------------------------------------------------------------
# The model under attn_impl="pallas_fused".
# ---------------------------------------------------------------------------

# Relative to the output's largest magnitude, as in test_torch_models.py.
# f32: the same arithmetic in another summation order. bf16: inner values
# round to bf16 on both sides, at places that differ where they straddle a
# tie; the bound covers a few such roundings.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def small_config(dtype="float32", attn_impl="pallas_fused", adaln=True):
  """Width 128, 2 heads of 64, depth 2 + 1, 16 px: L = 16 + 4 cls."""
  config = ae_i1k.get_config(
      f"runlocal,size=16,adaln={adaln},attn_impl={attn_impl}")
  config["model"].update(width=128, num_heads=2, dtype_mm=dtype)
  return config


def _close(got, want, rel):
  err = np.max(np.abs(got - want))
  assert err <= rel * np.max(np.abs(want)), (err, np.max(np.abs(want)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("adaln", [True, False])
def test_block_matches_jax_under_pallas_fused(adaln, dtype):
  jdt, tdt = DTYPES[dtype]
  config = small_config(dtype, adaln=adaln)
  params = convert.init_params(config, seed=1)["Encoder"]["blocks_00"]
  rng = np.random.default_rng(0)
  x = rng.standard_normal((2, 20, 128)).astype(np.float32)
  cond = rng.standard_normal((2, 128)).astype(np.float32)
  want, _ = jvit.Block(num_heads=2, adaln=adaln, dtype_mm=dtype,
                       attn_impl="pallas_fused_interpret").apply(
                           {"params": params}, jnp.asarray(x, jdt),
                           jnp.asarray(cond, jdt))
  block = tvit.Block(128, None, 2, adaln, tdt,
                     "pallas_fused").requires_grad_(False)
  block.load_state_dict(convert.params_from_jax(params, block))
  got = block(torch.from_numpy(x).to(tdt), torch.from_numpy(cond).to(tdt))
  assert got.dtype == tdt and got.shape == (2, 20, 128)
  _close(_np(got), np.asarray(want, np.float32), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax_under_pallas_fused(dtype):
  config = small_config(dtype)
  params = convert.init_params(config, seed=2)
  rng = np.random.default_rng(1)
  image = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
  t = np.array([1, 400, 1000], np.int32)
  jmodel = jae.Model(**{"scan": False, **config["model"],
                        "attn_impl": "pallas_fused_interpret"})
  want, jout = jmodel.apply({"params": params}, image, t=t)
  model = train_ae.build_model(config, device="cpu")
  model.load_state_dict(convert.params_from_jax(params, model))
  got, tout = model(torch.from_numpy(image), t=torch.from_numpy(t).long())
  assert got.dtype == torch.float32 and got.shape == (3, 16, 16, 6)
  _close(got.numpy(), np.asarray(want), TOL[dtype])
  _close(_np(tout["pre_logits"]), np.asarray(jout["pre_logits"], np.float32),
         TOL[dtype])


def test_fused_and_unfused_forward_agree_f32():
  """The two settings compute the same function up to f32 rounding."""
  config = small_config()
  params = convert.init_params(config, seed=3)
  image = torch.from_numpy(np.random.default_rng(2).standard_normal(
      (2, 16, 16, 3)).astype(np.float32))
  t = torch.tensor([5, 700])
  preds = []
  for impl in ("pallas", "pallas_fused"):
    model = train_ae.build_model(small_config(attn_impl=impl), device="cpu")
    model.load_state_dict(convert.params_from_jax(params, model))
    preds.append(model(image, t=t)[0])
  torch.testing.assert_close(preds[0], preds[1], rtol=1e-4, atol=1e-4)


def test_param_names_are_the_same_under_both_settings():
  """One parameter tree for both settings, and it is the JAX package's, so
  the bridge needs no new names."""
  names = {}
  for impl in ("pallas", "pallas_fused"):
    config = small_config(attn_impl=impl)
    names[impl] = {k: tuple(v.shape) for k, v in tree_flatten_with_names(
        convert.init_params(config, 0))}
  assert names["pallas"] == names["pallas_fused"]
  config = small_config()
  jmodel = jae.Model(**{"scan": False, **config["model"],
                        "attn_impl": "pallas_fused_interpret"})
  shapes = jax.eval_shape(
      lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                          t=jnp.zeros((1,), jnp.int32)))
  want = {k: tuple(v.shape) for k, v in tree_flatten_with_names(
      jax.tree.map(lambda a: a, shapes["params"]))}
  assert names["pallas_fused"] == want
  # A tree saved under one setting loads under the other.
  model = train_ae.build_model(small_config(attn_impl="pallas"),
                               device="cpu")
  model.load_state_dict(convert.params_from_jax(
      convert.init_params(small_config(), 0), model))


# "xla" and "flax" are ported (tests/test_torch_model_settings.py); the
# JAX package's interpret-mode settings exist for its CPU tests only.
@pytest.mark.parametrize("impl", ["pallas_interpret",
                                  "pallas_fused_interpret", "triton"])
def test_other_attn_impls_raise(impl):
  with pytest.raises(ValueError, match="attn_impl"):
    train_ae.build_model(small_config(attn_impl=impl), device="cpu")
  with pytest.raises(ValueError, match="attn_impl"):
    tvit.MlpBlock(128, None, torch.float32, impl)
