"""Port parity: the UMD model (Block, _ViTAE forward, CFG, timestep embed).

Weights come from the port's `convert.init_params` (every leaf drawn from a
seed, none of them zero, so the AdaLN gates are live) and reach the JAX
modules as the same flax-named numpy tree. The JAX side runs its Pallas
kernels in interpret mode (`attn_impl="pallas_interpret"`), the port its
plain versions on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_vision_tpu.models import ae as jae
from small_vision_tpu.models import embeddings as jemb
from small_vision_tpu.models import vit as jvit
from small_vision_tpu_torch import convert
from small_vision_tpu_torch.configs import ae_i1k
from small_vision_tpu_torch.models import embeddings as temb
from small_vision_tpu_torch.models import vit as tvit
from small_vision_tpu_torch.train import train_ae
from small_vision_tpu_torch.utils.trees import tree_flatten_with_names

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def small_config(adaln=True, labels=False, dtype="float32"):
  """Width 64, depth 2, decoder depth 1, 4 heads, 16 px: L = 16 + 4 cls."""
  config = ae_i1k.get_config(
      f"runlocal,size=16,adaln={adaln},use_labels={labels}")
  config["model"]["dtype_mm"] = dtype
  return config


def jax_model(config):
  return jae.Model(**config["model"], attn_impl="pallas_interpret",
                   scan=False)


def torch_model(config, params):
  model = train_ae.build_model(config, device="cpu")
  model.load_state_dict(convert.params_from_jax(params, model))
  return model


def _close(got, want, rel):
  """max |got - want| within `rel` of max |want| (a scale-free bound)."""
  err = np.max(np.abs(got - want))
  assert err <= rel * np.max(np.abs(want)), (err, np.max(np.abs(want)))


@pytest.mark.parametrize("adaln", [True, False])
def test_param_names_are_flaxs(adaln):
  config = small_config(adaln=adaln, labels=True)
  shapes = jax.eval_shape(
      lambda: jax_model(config).init(
          jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
          t=jnp.zeros((1,), jnp.int32), y=jnp.zeros((1,), jnp.int32)))
  want = {k: tuple(v.shape) for k, v in
          tree_flatten_with_names(jax.tree.map(lambda a: a,
                                               shapes["params"]))}
  got = {k: tuple(v.shape) for k, v in
         tree_flatten_with_names(convert.init_params(config, 0))}
  assert got == want


# Tolerances, relative to the output's largest magnitude. f32: the same
# arithmetic in another summation order, through a few unit-variance
# blocks. bf16: every matmul output and the residual stream round to bf16
# (2^-8 relative) on both sides, at places that differ where the rounded
# values straddle a tie; the bound covers a few such roundings.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("adaln", [True, False])
def test_block_matches_jax(adaln, dtype):
  jdt, tdt = DTYPES[dtype]
  config = small_config(adaln=adaln, dtype=dtype)
  params = convert.init_params(config, seed=1)["Encoder"]["blocks_00"]
  rng = np.random.default_rng(0)
  x = rng.standard_normal((2, 20, 64)).astype(np.float32)
  cond = rng.standard_normal((2, 64)).astype(np.float32)
  want, _ = jvit.Block(num_heads=4, adaln=adaln, dtype_mm=dtype,
                       attn_impl="pallas_interpret").apply(
                           {"params": params}, jnp.asarray(x, jdt),
                           jnp.asarray(cond, jdt))
  block = tvit.Block(64, None, 4, adaln, tdt).requires_grad_(False)
  block.load_state_dict(convert.params_from_jax(params, block))
  got = block(torch.from_numpy(x).to(tdt), torch.from_numpy(cond).to(tdt))
  assert got.dtype == tdt and got.shape == (2, 20, 64)
  _close(got.float().numpy(), np.asarray(want, np.float32), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("adaln", [True, False])
def test_forward_matches_jax(adaln, dtype):
  config = small_config(adaln=adaln, dtype=dtype)
  params = convert.init_params(config, seed=2)
  rng = np.random.default_rng(1)
  image = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
  t = np.array([1, 400, 1000], np.int32)
  want, jout = jax_model(config).apply({"params": params}, image, t=t)
  got, tout = torch_model(config, params)(torch.from_numpy(image),
                                          t=torch.from_numpy(t).long())
  assert got.dtype == torch.float32 and got.shape == (3, 16, 16, 6)
  _close(got.numpy(), np.asarray(want), TOL[dtype])
  _close(tout["pre_logits"].float().numpy(),
         np.asarray(jout["pre_logits"], np.float32), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cfg_double_batch_matches_jax(dtype):
  config = small_config(labels=True, dtype=dtype)
  params = convert.init_params(config, seed=3)
  rng = np.random.default_rng(2)
  image = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
  t = np.array([10, 900], np.int32)
  y = np.array([3, 999], np.int32)
  want, _ = jax_model(config).apply({"params": params}, image, t=t, y=y,
                                    cfg_scale=2.5)
  model = torch_model(config, params)
  got, _ = model(torch.from_numpy(image), t=torch.from_numpy(t).long(),
                 y=torch.from_numpy(y).long(), cfg_scale=2.5)
  assert got.shape == (2, 16, 16, 6)
  # Guidance extrapolates (cond - uncond) by 2.5, which scales the
  # rounding differences of the two halves by up to 2 * 2.5 + 1.
  _close(got.numpy(), np.asarray(want), 6 * TOL[dtype])
  # The doubled batch is the conditional and the null-label forward.
  cond, _ = model(torch.from_numpy(image), t=torch.from_numpy(t).long(),
                  y=torch.from_numpy(y).long())
  null, _ = model(torch.from_numpy(image), t=torch.from_numpy(t).long())
  torch.testing.assert_close(got, null + 2.5 * (cond - null), rtol=1e-4,
                             atol=1e-4)


def test_cfg_needs_labels():
  config = small_config()
  model = torch_model(config, convert.init_params(config, seed=0))
  with pytest.raises(ValueError, match="cfg_scale needs labels"):
    model(torch.zeros(1, 16, 16, 3), t=torch.ones(1, dtype=torch.long),
          cfg_scale=2.0)


def test_masking_waits_for_training_slice():
  config = small_config()
  model = torch_model(config, convert.init_params(config, seed=0))
  with pytest.raises(NotImplementedError):
    model(torch.zeros(1, 16, 16, 3), mask=0.75)


def _timestep_embeds(jdt, tdt):
  t = np.arange(1, 1001, dtype=np.int32)
  want = jemb.TimestepEmbed(768, dtype=jdt).apply({}, jnp.asarray(t))
  got = temb.TimestepEmbed(768, dtype=tdt)(torch.from_numpy(t).long())
  assert got.dtype == tdt
  return got.float().numpy(), np.asarray(want, np.float32)


def test_timestep_embed_bf16_equals_jax_for_every_t():
  """bf16 rounds t itself (993 -> 992) and t * freqs; the port must round
  at the same places, for every timestep the sampler feeds (1..1000)."""
  got, want = _timestep_embeds(jnp.bfloat16, torch.bfloat16)
  np.testing.assert_array_equal(got, want)


def test_timestep_embed_f32_matches_jax_for_every_t():
  got, want = _timestep_embeds(jnp.float32, torch.float32)
  # sin/cos of angles up to 1000 rad: the two libraries reduce the f32
  # argument differently, which can move the result by one ulp of the
  # angle (2^-14 at 1000); allow two.
  np.testing.assert_allclose(got, want, rtol=0, atol=2 * 2.0**-14)
