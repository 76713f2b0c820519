"""Port parity: the model settings. `scan` with its stacked layout, the
remat policies, the `heads` knob, UMD-S and runlocal, `attn_impl` "xla"
and "flax".

  - The config dicts for `heads=6`, `scan=True`, `variant=S/4`,
    `runlocal` and the attention settings equal the JAX `ConfigDict`s, and
    so do `fsdp=True`'s sharding fields.
  - Under `scan=True` the parameters carry flax `nn.scan`'s names and
    shapes (`Encoder/blocks/...`, depth first), from `jax.eval_shape` of the
    JAX model; `stack_blocks` / `unstack_blocks` round-trip exactly, both
    ways, and so do the optimizer's mu and nu through
    `opt_state_from_jax`.
  - The sampler's functions on `scan=True` parameters carried from JAX
    against JAX's `scan=True` model (its Pallas kernels interpreted).
  - Each remat policy's gradients are the bits of the port's no-remat
    gradients on the CPU, under "pallas" and "pallas_fused", unrolled and
    stacked.
  - "xla" and "flax": the forward and the gradients against the JAX model
    under the same setting (XLA ops there; matmuls and a softmax here).
  - Head dim 128 (the `heads` knob's shape): the forward against JAX; head
    dims 192 (`heads=4`'s), 384 (`heads=2`'s: the card's wide path) and 12
    (`heads=32`'s at UMD-S, which the card runs on heads zero-padded to
    16) under "pallas" and "pallas_fused": the forward and the gradients
    against JAX's interpreted kernels.
The training step under `scan=True` and with dropout, and a `scan=True`
run resumed, are in tests/test_torch_model_settings_step.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_diffusion import jax_loop_draws
from test_torch_models import _close, jax_model, torch_model

from small_vision_tpu.configs import ae_i1k as jconfig
from small_vision_tpu.configs import ae_i1k_lp as jconfig_lp
from small_vision_tpu.ops import diffusion as jdiff
from small_vision_tpu.train import train_ae as jtrain
from small_vision_tpu_torch import convert
from small_vision_tpu_torch.configs import ae_i1k, ae_i1k_lp
from small_vision_tpu_torch.models import vit as tvit
from small_vision_tpu_torch.ops import diffusion as tdiff
from small_vision_tpu_torch.train import train_ae
from small_vision_tpu_torch.utils.trees import tree_flatten_with_names


def small(extra="", dtype="float32", **model):
  """runlocal at 16 px (width 64, 4 heads of 16, depth 2 + 1) with the
  model's fields overridden."""
  config = ae_i1k.get_config(f"runlocal,size=16{extra}")
  config["model"].update(dtype_mm=dtype, **model)
  return config


@pytest.mark.parametrize("arg", [
    "heads=6", "scan=True", "heads=6,scan=True", "variant=S/4", "runlocal",
    "runlocal,scan=True", "attn_impl=xla", "attn_impl=flax",
    "variant=L/2,size=256,latent_diffusion=True,scan=True",
    "heads=6,scan=True,attn_impl=pallas_fused", "heads=4", "heads=3",
    "heads=4,attn_impl=pallas_fused", "variant=S/4,heads=32",
    "variant=S/4,heads=32,attn_impl=pallas_fused", "heads=2", "heads=1",
    "heads=1,attn_impl=pallas_fused"])
def test_config_dicts_match_jax(arg):
  arg = f"data=synthetic,{arg}"
  got, want = ae_i1k.get_config(arg), jconfig.get_config(arg)
  assert got["model"] == dict(want.model), arg
  for key in ("mask_ratio", "no_noise_prob"):
    assert got[key] == want[key], key
  assert got["input"]["batch_size"] == want.input.batch_size


def test_lp_config_takes_scan_and_fsdp_raises():
  for arg in ("scan=True", "runlocal,scan=True,data=synthetic"):
    assert ae_i1k_lp.get_config(arg)["model"] == dict(
        jconfig_lp.get_config(arg).model), arg
  for arg in ("fsdp=True", "runlocal,fsdp=True,data=synthetic"):
    got, want = ae_i1k.get_config(arg), jconfig.get_config(arg)
    assert got["model"]["scan"] == want.model["scan"], arg
    for key in ("param_sharding", "optim_sharding", "mesh_fsdp"):
      assert got[key] == want[key], (arg, key)


def test_scan_param_names_and_shapes_are_flaxs():
  config = small(scan=True, num_classes=10)
  shapes = jax.eval_shape(
      lambda: jax_model(config).init(
          jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
          t=jnp.zeros((1,), jnp.int32), y=jnp.zeros((1,), jnp.int32)))
  want = {k: tuple(v.shape) for k, v in
          tree_flatten_with_names(shapes["params"])}
  got = {k: tuple(v.shape) for k, v in
         tree_flatten_with_names(convert.init_params(config, 0))}
  assert got == want
  assert want["Encoder/blocks/MultiHeadAttention_0/query/kernel"] == (
      2, 64, 4, 16)
  model = train_ae.build_model(config, device="meta")
  assert {k.replace(".", "/"): tuple(v.shape)
          for k, v in model.state_dict().items()} == want


def test_layout_round_trip_is_exact_both_ways():
  unrolled = small()
  stacked = small(scan=True)
  flat = dict(tree_flatten_with_names(convert.init_params(unrolled, 5)))
  flat_s = dict(tree_flatten_with_names(convert.init_params(stacked, 5)))
  # One seed, the same weights in either layout.
  to_s = dict(tree_flatten_with_names(convert.stack_blocks(flat)))
  assert to_s.keys() == flat_s.keys()
  for name, a in flat_s.items():
    np.testing.assert_array_equal(to_s[name], a)
  back = dict(tree_flatten_with_names(convert.unstack_blocks(flat_s)))
  assert back.keys() == flat.keys()
  for name, a in flat.items():
    np.testing.assert_array_equal(back[name], a)
  # Through a model: loaded from either layout, given back in either.
  model = train_ae.build_model(stacked, device="cpu")
  model.load_state_dict(convert.params_from_jax(flat, model))
  for stack, want in ((True, flat_s), (False, flat), (None, flat_s)):
    got = dict(tree_flatten_with_names(
        convert.params_to_jax(model.state_dict(), stacked=stack)))
    assert got.keys() == want.keys()
    for name, a in want.items():
      np.testing.assert_array_equal(got[name], a)
  # AdamW's mu (bf16) and nu, keyed as the parameters, in the other layout.
  names = [n for n, _ in train_ae.named_params(model)]
  mu = {n: a.astype(jnp.bfloat16) for n, a in flat.items()}
  nu = {n: np.abs(a) for n, a in flat.items()}
  opt, _ = convert.opt_state_from_jax(names, count=3, mu=mu, nu=nu)
  for n, m, v in zip(names, opt["mu"], opt["nu"]):
    assert m.dtype == torch.bfloat16
    np.testing.assert_array_equal(v.numpy(), np.abs(flat_s[n]))
    np.testing.assert_array_equal(
        m.float().numpy(), np.asarray(flat_s[n].astype(jnp.bfloat16),
                                      np.float32))


@pytest.mark.parametrize("fn,labels", [("uncond_eps", False),
                                       ("cfg_x0_2.0", True)])
def test_scan_sampler_matches_jax_f32(fn, labels):
  """The 4-step sampler on `scan=True` parameters carried from JAX, with
  the JAX loop's draws, against JAX's `scan=True` model: the bounds of
  tests/test_torch_sampler.py (uint8 samples at most one level apart, at
  most 1 % of them)."""
  config = small(f",use_labels={labels}", scan=True)
  config["num_samples_per_call"] = 4
  config["diff_schedule"]["sampling_timesteps"] = 4
  params = convert.init_params(config, seed=4)
  key = jax.random.PRNGKey(7)
  want = jtrain.make_eval_fns(jax_model(config), config)[fn](
      {"params": params, "gd": jdiff.GaussianDiffusion.create("cosine")}, key)
  loop_key, _ = jax.random.split(key)
  got = train_ae.make_eval_fns(torch_model(config, params), config)[fn](
      tdiff.GaussianDiffusion.create("cosine", device="cpu"),
      torch.Generator().manual_seed(0),
      noise=jax_loop_draws(loop_key, (4, 16, 16, 3), 4))
  images = got["fid_samples"].numpy()
  assert images.shape == (4, 16, 16, 3)
  off = np.abs(images.astype(int) - np.asarray(want["fid_samples"], int))
  assert off.max() <= 1 and np.mean(off > 0) <= 0.01


def _grads(config, params, image, t):
  model = train_ae.build_model(config, device="cpu", trainable=True)
  model.load_state_dict(convert.params_from_jax(params, model))
  pred, _ = model(torch.from_numpy(image), t=torch.from_numpy(t).long())
  named = train_ae.named_params(model)
  grads = torch.autograd.grad(pred.square().mean(), [p for _, p in named],
                              allow_unused=True)
  return pred.detach(), {n: g for (n, _), g in zip(named, grads)}


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("attn_impl", ["pallas", "pallas_fused"])
@pytest.mark.parametrize("policy", ["nothing_saveable",
                                    "everything_saveable", "save_attn",
                                    "save_attn_mlp"])
def test_remat_gradients_are_the_no_remat_bits(policy, attn_impl, scan):
  rng = np.random.default_rng(0)
  image = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
  t = np.array([1, 500, 999], np.int32)
  params = convert.init_params(small(scan=scan), seed=6)
  base = _grads(small(scan=scan, attn_impl=attn_impl, remat_policy="none"),
                params, image, t)
  got = _grads(small(scan=scan, attn_impl=attn_impl, remat_policy=policy),
               params, image, t)
  assert torch.equal(got[0], base[0])
  for name, g in base[1].items():
    assert (g is None and got[1][name] is None) or torch.equal(
        got[1][name], g), name


def test_unported_remat_policy_raises():
  with pytest.raises(ValueError, match="dots_saveable.*save_attn_mlp"):
    train_ae.build_model(small(scan=True, remat_policy="dots_saveable"),
                         device="meta")


def _jax_grads(config, params, image, t, build=None):
  model = (build or jax_model_raw)(config)

  def loss(p):
    pred = model.apply({"params": p}, image, t=t)[0]
    return jnp.mean(jnp.square(pred)), pred
  (_, pred), grads = jax.value_and_grad(loss, has_aux=True)(
      jax.tree.map(jnp.asarray, params))
  return np.asarray(pred), dict(tree_flatten_with_names(grads))


def jax_model_raw(config):
  """The JAX model with `attn_impl` as the config has it ("xla" and "flax"
  run XLA ops, no Pallas kernel)."""
  from small_vision_tpu.models import ae as jae
  return jae.Model(**{"scan": False, **config["model"]})


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("attn_impl", ["xla", "flax"])
def test_reference_attentions_match_jax(attn_impl, scan):
  """The forward and every parameter's gradient of a mean-square loss, in
  f32, against the JAX model under the same `attn_impl`: the same f32
  arithmetic in another order (1e-5 of the output's largest magnitude, as
  tests/test_torch_models.py; gradients 1e-4 of each leaf's largest, or
  1e-6 of the largest gradient where a leaf's is round-off)."""
  config = small(scan=scan, attn_impl=attn_impl)
  params = convert.init_params(config, seed=7)
  rng = np.random.default_rng(3)
  image = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
  t = np.array([2, 300, 1000], np.int32)
  want_pred, want = _jax_grads(config, params, image, t)
  pred, got = _grads(config, params, image, t)
  _close(pred.numpy(), want_pred, 1e-5)
  top = max(np.max(np.abs(np.asarray(w))) for w in want.values())
  for name, w in want.items():
    w = np.asarray(w)
    g = got[name].numpy() if got[name] is not None else np.zeros_like(w)
    err = np.max(np.abs(g - w))
    assert err <= max(1e-4 * np.max(np.abs(w)), 1e-6 * top), (name, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn_impl", ["xla", "flax"])
def test_reference_attention_modules_match_jax(attn_impl, dtype):
  """The attention sub-module alone at head dim 128 (2 heads at width
  256), in the working dtype: f32 1e-5, bf16 2e-2 of the largest output
  (the rounding bounds of tests/test_torch_models.py)."""
  from small_vision_tpu.models import vit as jvit
  jdt, tdt = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
  rng = np.random.default_rng(11)
  x = rng.standard_normal((2, 21, 256)).astype(np.float32)
  jmha = jvit.MultiHeadAttention(num_heads=2, dtype_mm=dtype,
                                 attn_impl=attn_impl)
  params = jmha.init(jax.random.PRNGKey(1), jnp.zeros((1, 4, 256)))["params"]
  want = jmha.apply({"params": params}, jnp.asarray(x, jdt))
  mha = tvit.MultiHeadAttention(256, 2, tdt, attn_impl).requires_grad_(False)
  mha.load_state_dict(convert.params_from_jax(params, mha))
  got = mha(torch.from_numpy(x).to(tdt))
  assert got.dtype == tdt
  _close(got.float().numpy(), np.asarray(want, np.float32),
         {"float32": 1e-5, "bfloat16": 2e-2}[dtype])


@pytest.mark.parametrize("scan", [False, True])
def test_head_dim_128_forward_matches_jax(scan):
  """Width 256 in 2 heads of 128 (the shape `heads=6` gives at 768),
  pallas: the plain K1-K4 against the JAX model with its kernels
  interpreted, f32, 1e-5 of the largest output."""
  config = small(scan=scan, width=256, num_heads=2)
  params = convert.init_params(config, seed=8)
  rng = np.random.default_rng(4)
  image = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
  t = np.array([5, 700], np.int32)
  want, _ = jax_model(config).apply({"params": params}, image, t=t)
  got, _ = torch_model(config, params)(torch.from_numpy(image),
                                       t=torch.from_numpy(t).long())
  _close(got.numpy(), np.asarray(want), 1e-5)


def _hold_wide_step(attn_impl, num_heads):
  """Width 384 in `num_heads` heads, depth 1 + 1, under `attn_impl` (the
  plain K1-K6 here) against the JAX model under its `*_interpret` setting:
  the forward and every parameter's gradient of a mean-square loss in
  f32, with test_reference_attentions_match_jax's bounds."""
  config = small(attn_impl=attn_impl, width=384, num_heads=num_heads,
                 depth=1, dec_depth=1)
  params = convert.init_params(config, seed=9)
  rng = np.random.default_rng(5)
  image = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
  t = np.array([3, 800], np.int32)
  want_pred, want = _jax_grads(config, params, image, t, jax_model)
  pred, got = _grads(config, params, image, t)
  _close(pred.numpy(), want_pred, 1e-5)
  top = max(np.max(np.abs(np.asarray(w))) for w in want.values())
  for name, w in want.items():
    w = np.asarray(w)
    g = got[name].numpy() if got[name] is not None else np.zeros_like(w)
    err = np.max(np.abs(g - w))
    assert err <= max(1e-4 * np.max(np.abs(w)), 1e-6 * top), (name, err)


@pytest.mark.parametrize("attn_impl", ["pallas", "pallas_fused"])
def test_head_dim_192_step_matches_jax(attn_impl):
  """Width 384 in 2 heads of 192 (the head dim `heads=4` gives at 768;
  three 64-column tiles a head on the card): `_hold_wide_step`."""
  _hold_wide_step(attn_impl, 2)


@pytest.mark.parametrize("attn_impl", ["pallas", "pallas_fused"])
def test_head_dim_384_step_matches_jax(attn_impl):
  """Width 384 in one head of 384 (the head dim `heads=2` gives at 768;
  six 64-column tiles a head, the card's wide path): `_hold_wide_step`."""
  _hold_wide_step(attn_impl, 1)


@pytest.mark.parametrize("attn_impl", ["pallas", "pallas_fused"])
def test_head_dim_12_step_matches_jax(attn_impl):
  """Width 96 in 8 heads of 12 (the head dim `heads=32` gives at UMD-S's
  384; the card's wrappers run it on heads zero-padded to 16), depth
  2 + 1, under `attn_impl` (the plain K1-K6 here) against the JAX model
  under its `*_interpret` setting: the forward and every parameter's
  gradient of a mean-square loss in f32, with
  test_reference_attentions_match_jax's bounds."""
  config = small(attn_impl=attn_impl, width=96, num_heads=8)
  params = convert.init_params(config, seed=10)
  rng = np.random.default_rng(6)
  image = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
  t = np.array([4, 900], np.int32)
  want_pred, want = _jax_grads(config, params, image, t, jax_model)
  pred, got = _grads(config, params, image, t)
  _close(pred.numpy(), want_pred, 1e-5)
  top = max(np.max(np.abs(np.asarray(w))) for w in want.values())
  for name, w in want.items():
    w = np.asarray(w)
    g = got[name].numpy() if got[name] is not None else np.zeros_like(w)
    err = np.max(np.abs(g - w))
    assert err <= max(1e-4 * np.max(np.abs(w)), 1e-6 * top), (name, err)
