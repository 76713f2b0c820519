"""Port parity: the DDIM sampler functions of the trainer, model included.

The port's `make_eval_fns` samplers run with the JAX loop's noise injected:
the JAX sampler splits its key once for the labels and hands the rest to
`ddim_sample_loop`, whose draws `jax_loop_draws` reproduces. The model is
the small UMD (width 64, 16 px), weights from `convert.init_params`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_diffusion import jax_loop_draws
from test_torch_models import TOL, jax_model, small_config, torch_model

from small_vision_tpu.ops import diffusion as jdiff
from small_vision_tpu.train import train_ae as jtrain
from small_vision_tpu_torch import convert
from small_vision_tpu_torch.ops import diffusion as tdiff
from small_vision_tpu_torch.train import train_ae as ttrain

STEPS, N = 4, 4
SHAPE = (N, 16, 16, 3)


def _setup(dtype, labels=False):
  config = small_config(labels=labels, dtype=dtype)
  config["num_samples_per_call"] = N
  config["diff_schedule"]["sampling_timesteps"] = STEPS
  params = convert.init_params(config, seed=4)
  return config, params, jax_model(config), torch_model(config, params)


def _eps_fns(params, jmodel, tmodel):
  """The samplers' eps model (t + 1 shift, eps half of the head)."""
  jeps = lambda x_t, t, rng=None, y=None, cfg_scale=None: jmodel.apply(
      {"params": params}, x_t, t=t + 1)[0][..., 3:]
  teps = lambda x_t, t, y=None, cfg_scale=None: tmodel(x_t, t=t + 1)[0][
      ..., 3:]
  return jeps, teps


def test_loop_x0_matches_jax_f32():
  config, params, jmodel, tmodel = _setup("float32")
  jeps, teps = _eps_fns(params, jmodel, tmodel)
  key = jax.random.PRNGKey(5)
  kw = dict(sampling_steps=STEPS, eta=1.0, clip_denoised=True)
  want = jdiff.ddim_sample_loop(jdiff.GaussianDiffusion.create("cosine"),
                                jeps, key, SHAPE, **kw)["sample"]
  with torch.inference_mode():
    got = tdiff.ddim_sample_loop(
        tdiff.GaussianDiffusion.create("cosine", device="cpu"), teps, SHAPE,
        noise=jax_loop_draws(key, SHAPE, STEPS), **kw)["sample"]
  # The first step, from t = 999, turns eps into x0 through
  # sqrt(1/abar - 1) = 2.0e4: a few f32 ulps of a unit eps become 5e-3 on
  # the x0 that are not clipped, and carry into the later steps.
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                             atol=5e-3)


@pytest.mark.parametrize("fn,labels", [("uncond_eps", False),
                                       ("cfg_x0_2.0", True)])
def test_sample_fn_uint8_matches_jax_f32(fn, labels):
  config, params, jmodel, tmodel = _setup("float32", labels)
  jgd = jdiff.GaussianDiffusion.create("cosine")
  key = jax.random.PRNGKey(7)
  want = jtrain.make_eval_fns(jmodel, config)[fn](
      {"params": params, "gd": jgd}, key)
  loop_key, _ = jax.random.split(key)
  got = ttrain.make_eval_fns(tmodel, config)[fn](
      tdiff.GaussianDiffusion.create("cosine", device="cpu"),
      torch.Generator().manual_seed(0),
      noise=jax_loop_draws(loop_key, SHAPE, STEPS))
  images = got["fid_samples"].numpy()
  assert images.dtype == np.uint8 and images.shape == SHAPE
  if labels:
    np.testing.assert_array_equal(got["ys"].numpy(), np.asarray(want["ys"]))
  off = np.abs(images.astype(int) - np.asarray(want["fid_samples"], int))
  # x0 agrees to 5e-3 (test_loop_x0_matches_jax_f32), i.e. 0.64 of a level
  # after *127.5: the truncating uint8 cast may land one level apart, and
  # does so only where x0 sits within that distance of a level boundary.
  assert off.max() <= 1
  assert np.mean(off > 0) <= 0.01


def test_ddim_step_with_model_matches_jax_bf16():
  """At bf16 (the config's setting) the 4-step loop amplifies each eps
  rounding by up to 2.0e4 at t = 999, so one model-driven step at t = 249
  is checked instead, against a bound derived from the model's."""
  config, params, jmodel, tmodel = _setup("bfloat16")
  jeps, teps = _eps_fns(params, jmodel, tmodel)
  rng = np.random.default_rng(3)
  x = rng.standard_normal(SHAPE).astype(np.float32)
  t, t_next = np.full(N, 249, np.int32), np.full(N, 241, np.int32)
  key = jax.random.PRNGKey(9)
  jgd = jdiff.GaussianDiffusion.create("cosine")
  want = jdiff.ddim_step(jgd, jeps, jnp.asarray(x), jnp.asarray(t),
                         jnp.asarray(t_next), key, eta=1.0,
                         clip_denoised=True)
  _, _, noise_rng = jax.random.split(key, 3)
  noise = np.asarray(jax.random.normal(noise_rng, SHAPE))
  tgd = tdiff.GaussianDiffusion.create("cosine", device="cpu")
  with torch.inference_mode():
    got = tdiff.ddim_step(tgd, teps, torch.from_numpy(x),
                          torch.from_numpy(t).long(),
                          torch.from_numpy(t_next).long(),
                          noise=torch.from_numpy(noise), eta=1.0,
                          clip_denoised=True)
  # The model's bf16 bound (TOL of max |eps|) through x0 = ... - eps *
  # sqrt(1/abar - 1); the step's own f32 arithmetic adds next to nothing.
  eps_max = float(np.max(np.abs(np.asarray(jeps(jnp.asarray(x),
                                                jnp.asarray(t))))))
  tol = TOL["bfloat16"] * eps_max * float(tgd.sqrt_recipm1_alphas_cumprod[249])
  for k in ("sample", "pred_xstart"):
    np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                               atol=tol, err_msg=k)
