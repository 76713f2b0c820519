"""Port parity at the dtypes and widths that K1-K4 take beside bf16 at the
variant tables' widths: f32 activations (`dtype_mm="float32"`, which the
TPU kernels take as they take bf16) and LayerNorm widths that are not a
multiple of 32 or are over 2,048.

  - The plain K1 and K2 at widths 1, 36, 100 and 2,080, in f32 and bf16,
    against the JAX package's kernel in interpret mode and its VJP, with
    the bounds of the width-256 tests (tests/test_torch_layernorm.py,
    tests/test_torch_ln_bwd.py).
  - A narrow UMD (width 36, 3 heads of 12, depth 2 + 1) under "pallas" in
    f32 and bf16: the forward, and one training step against JAX's
    `make_update_fn` under "pallas_interpret" (the helpers of
    tests/test_torch_train_step.py), with those tests' bounds.
  - The wrappers' checks, which need no card: they take f32 and every
    width from 1 to MAX_WIDTH, still name float16 and a width past
    MAX_WIDTH, pick the bf16 kernels' instances only where those take the
    rows, and load vectors that divide the width and the pointers.
  - K5's, K6's, K7's and K8's checks, which take f32 beside bf16 at every
    width and head dim from 1 to 2,048 (K9 still bf16 only), name float16,
    mixed dtypes and a head dim of 2,056, and launch f32 on the operands
    as they are (only bf16 ones are padded).
The training step under "pallas_fused" in f32 at depth 2 + 1 (K5 and K6
in f32 forward; K3, K4 in the backward) is held against the JAX
package's `pallas_fused_interpret` step by
tests/test_torch_train_step_variants.py (its `pallas_fused` case).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_layernorm import _inputs as _fwd_inputs
from test_torch_layernorm import _jax_both, _torch_plain
from test_torch_ln_bwd import _inputs as _bwd_inputs
from test_torch_ln_bwd import _jax_grads, _torch_grads, _ulp_bf16
from test_torch_models import TOL, _close, jax_model, torch_model
from test_torch_train_step import check_step1_grads, run_both
from test_torch_train_step import small_config as step_config
from test_torch_train_step import captured  # noqa: F401 (a fixture)

from small_vision_tpu_torch import convert
from small_vision_tpu_torch.configs import ae_i1k
from small_vision_tpu_torch.ops import attention as attn
from small_vision_tpu_torch.ops import fused_block as fb
from small_vision_tpu_torch.ops import layernorm as ln

# Beside the variant tables' multiples of 32 up to 2,048: one column, the
# narrow model's 36, 100 (a multiple of 4 but not 8) and 2,080 (past the
# bf16 kernels' widest row).
NEW_WIDTHS = (1, 36, 100, 2080)


@pytest.mark.parametrize("d", NEW_WIDTHS)
@pytest.mark.parametrize("modulate", [False, True])
def test_plain_forward_matches_jax_at_new_widths(d, modulate):
  """The plain K1 at width d against the interpreted JAX kernel and its
  XLA reference, with the bounds of the width-256 tests."""
  args = _fwd_inputs(33, modulate, seed=d, d=d)
  got = _torch_plain(*args, torch.float32)
  for want in _jax_both(*args, jnp.float32):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
  got = _torch_plain(*args, torch.bfloat16)
  for want in _jax_both(*args, jnp.bfloat16):
    # One bf16 ulp plus the f32 noise of values that cancel to near 0
    # (test_plain_matches_jax_at_variant_widths's bound).
    tol = _ulp_bf16(want) + 1e-5 * np.max(np.abs(want))
    assert np.all(np.abs(got - want) <= tol), np.max(np.abs(got - want))


@pytest.mark.parametrize("d", NEW_WIDTHS)
@pytest.mark.parametrize("modulate", [False, True])
def test_plain_backward_matches_jax_at_new_widths(d, modulate):
  """The plain K2 at width d against the interpreted JAX kernel's VJP, in
  f32 and bf16, with the bounds of test_backward_matches_jax_f32 and
  _bf16. At width 1 every x-hat, dx and dgamma is exactly 0 on both
  sides."""
  args = _bwd_inputs(33, modulate, seed=d + 7, d=d)
  got, _, _ = _torch_grads(*args, torch.float32)
  want, _, _ = _jax_grads(*args, jnp.float32)
  assert len(got) == len(want) == (5 if modulate else 3)
  for g, w in zip(got, want):
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.max(np.abs(w)))
  got, dtypes, _ = _torch_grads(*args, torch.bfloat16)
  want, _, _ = _jax_grads(*args, jnp.bfloat16)
  assert dtypes[0] == torch.bfloat16 and dtypes[1:3] == [torch.float32] * 2
  for i, (g, w) in enumerate(zip(got, want)):
    if i in (1, 2):
      np.testing.assert_allclose(g, w, rtol=0,
                                 atol=1e-5 * np.max(np.abs(w)))
    else:
      tol = _ulp_bf16(w) + 1e-5 * np.max(np.abs(w))
      assert np.all(np.abs(g - w) <= tol), np.max(np.abs(g - w))


def narrow(config):
  """`config` at width 36 in 3 heads of 12 (depth 2 + 1 as runlocal has
  it) under "pallas"."""
  config["model"].update(width=36, num_heads=3, attn_impl="pallas")
  return config


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_narrow_model_forward_matches_jax(dtype):
  """The narrow UMD's forward (K1 at width 36, K3 at head dim 12) against
  the JAX model under "pallas_interpret", with test_torch_models' bounds."""
  config = narrow(ae_i1k.get_config("runlocal,size=16"))
  config["model"]["dtype_mm"] = dtype
  params = convert.init_params(config, seed=4)
  rng = np.random.default_rng(8)
  image = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
  t = np.array([2, 450, 1000], np.int32)
  want, jout = jax_model(config).apply({"params": params}, image, t=t)
  got, tout = torch_model(config, params)(torch.from_numpy(image),
                                          t=torch.from_numpy(t).long())
  assert got.shape == (3, 16, 16, 6)
  _close(got.numpy(), np.asarray(want), TOL[dtype])
  _close(tout["pre_logits"].float().numpy(),
         np.asarray(jout["pre_logits"], np.float32), TOL[dtype])


def test_narrow_model_step_matches_jax_f32(captured):  # noqa: F811
  """One f32 training step of the narrow UMD (K1-K4 forward and backward
  at width 36 and head dim 12) against the JAX step: the loss and every
  leaf's gradient, with test_three_steps_match_jax_f32's step-1 bounds."""
  config = narrow(step_config())
  names, _, _, history = run_both(config, captured, 1)
  jmeas, tmeas, _, _ = history[0]
  np.testing.assert_allclose(float(tmeas["training_loss"]),
                             float(jmeas["training_loss"]), rtol=1e-5)
  np.testing.assert_allclose(float(tmeas["l2_grads"]),
                             float(jmeas["l2_grads"]), rtol=1e-4)
  check_step1_grads(names, history[0], 2e-5)


def test_narrow_model_step_matches_jax_bf16(captured):  # noqa: F811
  """The same step in bf16, with test_one_step_matches_jax_bf16's
  bounds."""
  config = narrow(step_config(dtype="bfloat16"))
  names, _, _, history = run_both(config, captured, 1)
  jmeas, tmeas, jnu, tnu = history[0]
  np.testing.assert_allclose(float(tmeas["training_loss"]),
                             float(jmeas["training_loss"]), rtol=2e-3)
  # Step 1's gradients per leaf, read from Adam's nu as check_step1_grads
  # reads them, within its bf16 bound (5e-2 of the leaf's max). The key
  # biases' gradient is 0 analytically (a shift of all of a query's scores
  # leaves its softmax as it was): in bf16 both sides hold round-off there
  # (7e-6 of a gradient norm of 2 at width 36, past check_step1_grads'
  # floor of 1e-5 of the norm), and not the same round-off, so theirs is
  # held under 1e-4 of the norm on both sides instead.
  norm = float(jmeas["l2_grads"])
  for name, got in zip(names, tnu):
    g_got = np.sqrt(got.numpy() / 0.05)
    g_want = np.sqrt(np.asarray(jnu[name]) / 0.05)
    if name.endswith("key/bias"):
      assert max(np.max(g_got), np.max(g_want)) <= 1e-4 * norm, name
      continue
    err = np.max(np.abs(g_got - g_want))
    assert err <= 5e-2 * max(np.max(g_want), 1e-5 * norm), (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", NEW_WIDTHS + (32, 768, ln.MAX_WIDTH))
def test_ln_checks_take_f32_and_every_width(dtype, d):
  x = torch.zeros(2, 3, d, dtype=dtype)
  ln.check_input(x, ln.NAME)
  shift, scale = torch.zeros(2, 6 * d, dtype=dtype).chunk(6, dim=-1)[:2]
  assert ln.check_modulation(x, shift, scale, ln.NAME) == 6 * d
  assert ln.check_modulation(x, None, None, ln.NAME) == 0
  # The bf16 kernels' instances take bf16 rows of a multiple of 32 up to
  # 2,048 with 16-byte vectors everywhere; every other input the any-width
  # instances.
  assert ln.bf16_rows(x, 6 * d, shift, scale) == (
      dtype == torch.bfloat16 and d % 32 == 0 and d <= ln.BF16_ROW_MAX)
  assert ln.launch_name(ln.NAME, x) == (
      ln.NAME_F32 if dtype == torch.float32 else ln.NAME)


def test_ln_checks_name_what_the_kernels_do_not_take():
  x = torch.zeros(2, 3, 64, dtype=torch.float16)
  with pytest.raises(ValueError, match="got torch.float16"):
    ln.check_input(x, ln.NAME)
  wide = torch.zeros(1, 1, ln.MAX_WIDTH + 1)
  with pytest.raises(ValueError, match=f"width {ln.MAX_WIDTH + 1}"):
    ln.check_input(wide, ln.BWD_NAME, "dy")
  with pytest.raises(ValueError, match="contiguous"):
    ln.check_input(torch.zeros(3, 2, 64).transpose(0, 1), ln.NAME)
  x = torch.zeros(2, 3, 64)
  bf = torch.zeros(2, 64, dtype=torch.bfloat16)
  with pytest.raises(ValueError, match="float32"):
    ln.check_modulation(x, bf, bf, ln.NAME)  # not x's dtype
  with pytest.raises(ValueError, match="together"):
    ln.check_modulation(x, None, torch.zeros(2, 64), ln.NAME)


@pytest.mark.parametrize("dtype,d,stride,offset,want", [
    (torch.float32, 768, 4608, 0, 4), (torch.bfloat16, 768, 4608, 0, 8),
    (torch.float32, 36, 216, 0, 4), (torch.bfloat16, 36, 216, 0, 4),
    (torch.bfloat16, 100, 600, 0, 4), (torch.float32, 1, 6, 0, 1),
    (torch.bfloat16, 2080, 0, 0, 8), (torch.float32, 2080, 0, 0, 4),
    (torch.float32, 768, 4608, 1, 1), (torch.bfloat16, 768, 4608, 2, 2),
    (torch.bfloat16, 768, 770, 0, 2)])
def test_ln_load_vector(dtype, d, stride, offset, want):
  """The elements of a load: up to 16 bytes, dividing the width and the
  modulation's stride, with every pointer aligned to them (a view
  `offset` elements into a buffer, at 1 and 2, halves or quarters it)."""
  buf = torch.zeros(2 * 3 * d + 8, dtype=dtype)
  x = buf[offset:offset + 2 * 3 * d].view(2, 3, d)
  assert ln.load_vector(x, stride, x) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,hd", [(3, 12), (12, 64), (1, 768),
                                      (1, 2048), (2, 1)])
def test_attention_checks_take_f32(dtype, heads, hd):
  """K3 and K4 take bf16 and f32 at every head dim from 1 to 2,048, and so
  do K7 and K8 (on [B, L, H, D]); K9 bf16 only."""
  q = torch.zeros(2, 5, heads * hd, dtype=dtype)
  assert attn.check_packed(attn.NAME, heads, attn.PACKED_DTYPES, q=q, k=q,
                           v=q) == (2, 5, hd)
  assert attn.check_packed(attn.BWD_NAME, heads, attn.PACKED_DTYPES, q=q,
                           k=q, v=q, do=q) == (2, 5, hd)
  q4 = q.view(2, 5, heads, hd)
  assert attn.check_unpacked(attn.UNPACKED_NAME, q=q4, k=q4, v=q4) == (
      2, 5, heads, hd)
  assert attn.check_unpacked(attn.UNPACKED_BWD_NAME, q=q4, k=q4, v=q4,
                             do=q4) == (2, 5, heads, hd)
  if dtype == torch.float32:
    with pytest.raises(ValueError, match="must be bfloat16, got"):
      attn.check_packed(attn.ABLATE_NAME, heads, q=q, k=q, v=q)


def test_attention_checks_name_what_the_kernels_do_not_take():
  q = torch.zeros(1, 4, 128, dtype=torch.float16)
  with pytest.raises(ValueError, match="got torch.float16"):
    attn.check_packed(attn.NAME, 2, attn.PACKED_DTYPES, q=q, k=q, v=q)
  q = torch.zeros(1, 4, 2 * 2056)
  with pytest.raises(ValueError, match="head dim 2056"):
    attn.check_packed(attn.BWD_NAME, 2, attn.PACKED_DTYPES, q=q, k=q, v=q,
                      do=q)
  f, b = torch.zeros(1, 4, 128), torch.zeros(1, 4, 128, dtype=torch.bfloat16)
  with pytest.raises(ValueError, match="contiguous"):
    attn.check_packed(attn.NAME, 2, attn.PACKED_DTYPES, q=f, k=b, v=f)


# K5's and K6's widths and head dims: (width, heads, head dim); square
# (the model's 768 in 12 heads of 64, one column, the narrow model's 36 in
# 3 heads of 12, UMD-S's 384 in `heads=32`'s 32 heads of 12, `heads=1`'s
# 768, the limit 2,048) and not (a tensor rank's 6 of 12 heads of 64; 100
# columns in 3 heads of 1).
FUSED_CASES = ((768, 12, 64), (1, 1, 1), (36, 3, 12), (384, 32, 12),
               (768, 1, 768), (2048, 1, 2048), (768, 6, 64), (100, 3, 1))


def _mlp(d, hidden, dtype):
  return (torch.zeros(2, 3, d, dtype=dtype),
          torch.zeros(d, hidden, dtype=dtype), torch.zeros(hidden, dtype=dtype),
          torch.zeros(hidden, d, dtype=dtype), torch.zeros(d, dtype=dtype))


def _mha(d, heads, hd, dtype):
  z = lambda *s: torch.zeros(*s, dtype=dtype)
  return (z(2, 3, d), z(d, heads * hd), z(heads * hd), z(d, heads * hd),
          z(heads * hd), z(d, heads * hd), z(heads * hd), z(heads * hd, d),
          z(d), heads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,heads,hd", FUSED_CASES)
def test_fused_checks_take_f32(dtype, d, heads, hd):
  """K5 and K6 take bf16 and f32 at every width and head dim from 1 to
  2,048, square or not (their wrappers' checks, which need no card)."""
  assert fb.check_mlp(*_mlp(d, 4 * d + 3, dtype)) == (6, d)
  assert fb.check_mha(*_mha(d, heads, hd, dtype)) == (2, 3, d, hd)


def test_fused_checks_name_what_the_kernels_do_not_take():
  with pytest.raises(ValueError, match="got torch.float16"):
    fb.check_mlp(*_mlp(36, 150, torch.float16))
  with pytest.raises(ValueError, match="got torch.float16"):
    fb.check_mha(*_mha(36, 3, 12, torch.float16))
  x, *rest = _mlp(36, 150, torch.float32)
  with pytest.raises(ValueError, match="w1 must be a contiguous float32"):
    fb.check_mlp(x, rest[0].to(torch.bfloat16), *rest[1:])
  x, *rest = _mha(36, 3, 12, torch.bfloat16)
  with pytest.raises(ValueError, match="x must be bfloat16 or float32"):
    fb.check_mha(x.half(), *rest)
  with pytest.raises(ValueError, match="head dim 2056"):
    fb.check_mha(*_mha(2056, 1, 2056, torch.float32))
  x, *rest = _mha(64, 2, 32, torch.float32)
  with pytest.raises(ValueError, match="contiguous"):
    fb.check_mha(x.transpose(0, 1), *rest)
  q4 = torch.zeros(1, 4, 2, 12, dtype=torch.float16)
  with pytest.raises(ValueError, match="got torch.float16"):
    attn.check_unpacked(attn.UNPACKED_NAME, q=q4, k=q4, v=q4)
  f, b = torch.zeros(1, 4, 2, 12), torch.zeros(1, 4, 2, 12,
                                               dtype=torch.bfloat16)
  with pytest.raises(ValueError, match="contiguous"):
    attn.check_unpacked(attn.UNPACKED_BWD_NAME, q=f, k=f, v=b, do=f)
  with pytest.raises(ValueError, match="head dim 2056"):
    attn.check_unpacked(attn.UNPACKED_NAME,
                        **dict.fromkeys("qkv", torch.zeros(1, 4, 1, 2056)))


@pytest.mark.parametrize("d,heads,hd", [(36, 3, 12), (100, 3, 1),
                                        (768, 12, 64)])
def test_f32_operands_are_not_padded(d, heads, hd):
  """f32 runs K5 and K6 on their arguments themselves and K7 and K8 at the
  true head dim (the f32 kernels take every width and head dim); bf16 on
  copies padded to multiples of 8 where a width or head dim is not one."""
  mlp = _mlp(d, 150, torch.float32)
  assert all(a is b for a, b in zip(fb.mlp_operands(*mlp), mlp))
  mha = _mha(d, heads, hd, torch.float32)
  assert all(a is b for a, b in zip(fb.mha_operands(*mha), mha[:-1]))
  assert attn.unpacked_head_dim(torch.float32, hd) == hd
  mlp16 = fb.mlp_operands(*_mlp(d, 150, torch.bfloat16))
  assert mlp16[1].shape == (-(-d // 8) * 8, 152)
  mha16 = fb.mha_operands(*_mha(d, heads, hd, torch.bfloat16))
  assert mha16[0].shape[-1] == -(-d // 8) * 8
  assert mha16[1].shape[-1] == heads * attn.padded_head_dim(hd)
  assert attn.unpacked_head_dim(torch.bfloat16, hd) == (
      attn.padded_head_dim(hd))
