"""Port parity: diffusion tables, the DDIM step and the sampling loop.

The JAX package draws its noise from a split PRNG sequence
(ops/diffusion.py: one split per loop start, three per step); the tests
reproduce that sequence and inject the same draws into the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_vision_tpu.ops import diffusion as jdiff
from small_vision_tpu_torch.ops import diffusion as tdiff

SHAPE = (3, 8, 8, 3)


@pytest.mark.parametrize("schedule", ["cosine", "linear"])
def test_tables_bit_equal(schedule):
  jgd = jdiff.GaussianDiffusion.create(schedule, 1000)
  tgd = tdiff.GaussianDiffusion.create(schedule, 1000, device="cpu")
  for field in dataclasses.fields(tgd):
    want = np.asarray(getattr(jgd, field.name))
    got = getattr(tgd, field.name).numpy()
    assert got.dtype == np.float32, field.name
    np.testing.assert_array_equal(got, want, err_msg=field.name)


def test_sampling_timesteps_equal():
  got = tdiff.sampling_timesteps(1000, 125)
  np.testing.assert_array_equal(got, jdiff.sampling_timesteps(1000, 125))
  assert len(got) == 126 and got[0] == 999 and got[-1] == 0


# The same eps model in both frameworks: smooth in x and t, no weights.
def _jax_eps(x_t, t, rng=None, y=None, cfg_scale=None):
  del rng, y, cfg_scale
  return jnp.tanh(x_t) * 0.7 + 1e-3 * t.reshape(-1, 1, 1, 1)


def _torch_eps(x_t, t, y=None, cfg_scale=None):
  del y, cfg_scale
  return torch.tanh(x_t) * 0.7 + 1e-3 * t.reshape(-1, 1, 1, 1)


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("clip", [False, True])
def test_ddim_step_matches_jax(final, clip):
  rng = np.random.default_rng(0)
  x = (rng.standard_normal(SHAPE) * 1.5).astype(np.float32)
  t = np.full((SHAPE[0],), 0 if final else 507, np.int32)
  t_next = None if final else np.full((SHAPE[0],), 499, np.int32)
  key = jax.random.PRNGKey(3)
  jgd = jdiff.GaussianDiffusion.create("cosine", 1000)
  want = jdiff.ddim_step(jgd, _jax_eps, jnp.asarray(x), jnp.asarray(t),
                         None if final else jnp.asarray(t_next), key,
                         eta=1.0, clip_denoised=clip)
  _, _, noise_rng = jax.random.split(key, 3)
  noise = np.asarray(jax.random.normal(noise_rng, SHAPE, jnp.float32))

  tgd = tdiff.GaussianDiffusion.create("cosine", 1000, device="cpu")
  got = tdiff.ddim_step(
      tgd, _torch_eps, torch.from_numpy(x), torch.from_numpy(t).long(),
      None if final else torch.from_numpy(t_next).long(),
      noise=torch.from_numpy(noise), eta=1.0, clip_denoised=clip)
  # f32 on both sides, same op order: only libm rounding differs.
  for k in ("sample", "pred_xstart"):
    np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                               rtol=0, atol=1e-5, err_msg=k)


def jax_loop_draws(key, shape, steps):
  """The draws ddim_sample_loop makes from `key`: x_T, then one per step
  (steps strided steps and the final t=0 step)."""
  key, init_rng = jax.random.split(key)
  draws = [jax.random.normal(init_rng, shape, jnp.float32)]
  for _ in range(steps + 1):
    key, _, noise_rng = jax.random.split(key, 3)
    draws.append(jax.random.normal(noise_rng, shape, jnp.float32))
  return [torch.from_numpy(np.asarray(d)) for d in draws]


@pytest.mark.parametrize("schedule", ["linear", "cosine"])
def test_ddim_sample_loop_matches_jax(schedule):
  steps = 4
  key = jax.random.PRNGKey(11)
  jgd = jdiff.GaussianDiffusion.create(schedule, 1000)
  want = jdiff.ddim_sample_loop(jgd, _jax_eps, key, SHAPE,
                                sampling_steps=steps, eta=1.0,
                                clip_denoised=True)["sample"]
  tgd = tdiff.GaussianDiffusion.create(schedule, 1000, device="cpu")
  got = tdiff.ddim_sample_loop(
      tgd, _torch_eps, SHAPE, noise=jax_loop_draws(key, SHAPE, steps),
      sampling_steps=steps, eta=1.0, clip_denoised=True)["sample"]
  # f32, 5 chained steps of the same arithmetic; XLA fuses the scan body
  # where torch rounds op by op, so each side is off by an ulp here and
  # there. The first step, from t = 999, turns eps into x0 through
  # sqrt(1/abar - 1): 157 on the linear schedule, 2.0e4 on the cosine one,
  # which makes an ulp of a unit value (2^-23) 2.4e-3 on the x0 that are
  # not clipped.
  amplification = float(tgd.sqrt_recipm1_alphas_cumprod[999])
  atol = max(1e-5, 2.0**-23 * amplification)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                             atol=atol)


def test_loop_rejects_wrong_noise_count():
  tgd = tdiff.GaussianDiffusion.create("cosine", 1000, device="cpu")
  with pytest.raises(ValueError, match="noise holds 2"):
    tdiff.ddim_sample_loop(tgd, _torch_eps, SHAPE,
                           noise=[torch.zeros(SHAPE)] * 2, sampling_steps=4)


def test_generator_draws_are_seeded():
  tgd = tdiff.GaussianDiffusion.create("cosine", 1000, device="cpu")
  run = lambda seed: tdiff.ddim_sample_loop(
      tgd, _torch_eps, SHAPE, generator=torch.Generator().manual_seed(seed),
      sampling_steps=3, clip_denoised=True)["sample"]
  torch.testing.assert_close(run(5), run(5), rtol=0, atol=0)
  assert not torch.equal(run(5), run(6))
