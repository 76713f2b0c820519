"""Port parity: the latent path of the trainer (`latent_diffusion`) against
the JAX package's `make_update_fn` and `make_eval_fns`.

In the shape of the JAX package's own tests/test_vae_latent.py: a UMD of
width 32 (4 heads, depth 1 + 1, patch 1, 4 channels) on the (4, 4, 4)
latents of a tiny AutoencoderKL (channels (32, 32, 32, 32)) of 32x32
images, the linear beta schedule, f32. The VAE's weights are the port's
seeded ones, carried to flax by `convert.vae_to_jax`. The JAX side runs its
attention kernels in interpret mode (`pallas_interpret`); the port runs
their plain versions on the CPU.

The JAX step and evaluation functions draw the VAE's noise from their
PRNG keys inside `vae_encode`; here they are handed a `vae_encode` closure
that takes the test's numpy draw instead, and the port gets the same draw
injected (`draws["vae_noise"]`). The step's other draws are injected as in
tests/test_torch_train_step.py (mask uniforms captured from the JAX step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_diffusion import jax_loop_draws
from test_torch_train_step import check_step1_grads, flat, install_capture

from small_vision_tpu import optim as joptim
from small_vision_tpu import parallel
from small_vision_tpu.configs import ae_i1k as jconfig
from small_vision_tpu.models import ae as jae
from small_vision_tpu.models import vae as jvae
from small_vision_tpu.ops import diffusion as jgd
from small_vision_tpu.train import train_ae as jtrain
from small_vision_tpu_torch import convert
from small_vision_tpu_torch.configs import ae_i1k
from small_vision_tpu_torch.models import vae as tvae
from small_vision_tpu_torch.ops import diffusion as tgd
from small_vision_tpu_torch.train import train_ae
from small_vision_tpu_torch.utils import checkpoint as ckpt_lib
from small_vision_tpu_torch.utils.chrono import Chrono

B, SIZE, T = 8, 32, 1000
LATENT = (4, 4, 4)
TINY = (32, 32, 32, 32)
OPT = dict(peak_lr=0.05, wd=0.05, betas=(0.9, 0.95), clip_norm=1.0,
           total_steps=10, warmup_steps=1)


def latent_config(pre_latents=False):
  config = ae_i1k.get_config("runlocal")
  config.update(latent_diffusion=True, use_preprocessed_latents=pre_latents,
                size=SIZE, diffusion_space=LATENT,
                peak_lr=OPT["peak_lr"], wd=OPT["wd"], betas=OPT["betas"],
                clip_norm=OPT["clip_norm"], num_samples_per_call=4)
  config["diff_schedule"] = dict(config["diff_schedule"],
                                 beta_schedule="linear", clip_denoised=False,
                                 sampling_timesteps=4)
  config["model"].update(width=32, depth=1, dec_depth=1, num_heads=4,
                         img_size=4, patch_size=(1, 1), channels=4,
                         dtype_mm="float32")
  config["input"]["batch_size"] = B
  return config


@pytest.fixture(scope="module")
def vae():
  """The port's seeded tiny VAE and its flax counterpart."""
  params, enc, dec = tvae.load_vae(device="cpu", seed=2,
                                   block_out_channels=TINY)
  jmodel = jvae.AutoencoderKL(block_out_channels=TINY)
  return params, enc, dec, jmodel, convert.vae_to_jax(params)


def jax_vae_fns(jmodel, noise):
  """JAX vae_encode / vae_decode closures; the encode takes `noise` (the
  test's draw) in place of jax.random.normal under its key."""
  def encode(p, rng, images, scale=True):
    del rng
    mean, logvar = jmodel.apply({"params": p}, images,
                                method=jmodel.encode_moments)
    return (mean + jnp.exp(0.5 * logvar) * noise) * tvae.SCALING_FACTOR

  def decode(p, latents, scale=True):
    return jmodel.apply({"params": p}, latents, scale=scale,
                        method=jmodel.decode)
  return encode, decode


def jax_model(config):
  kw = dict(config["model"])
  return jae.Model(**{"scan": False, **kw,
                      "attn_impl": kw["attn_impl"] + "_interpret"})


def torch_model(config, params, trainable=False):
  model = train_ae.build_model(config, device="cpu", trainable=trainable)
  model.load_state_dict(convert.params_from_jax(params, model))
  return model


def _inputs(seed):
  rng = np.random.default_rng(seed)
  images = np.clip(rng.standard_normal((B, SIZE, SIZE, 3)) * 0.5, -1,
                   1).astype(np.float32)
  vae_noise = rng.standard_normal((B,) + LATENT).astype(np.float32)
  return rng, images, vae_noise


def _rel(got, want):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def test_config_latent_fields_match_jax():
  arg = "variant=L/2,size=256,latent_diffusion=True"
  want, got = jconfig.get_config(arg), ae_i1k.get_config(arg)
  for key in ("latent_diffusion", "diffusion_space",
              "use_preprocessed_latents", "size"):
    assert tuple(np.atleast_1d(got[key])) == tuple(np.atleast_1d(want[key])), key
  for key in ("beta_schedule", "clip_denoised", "timesteps",
              "sampling_timesteps", "eta"):
    assert got["diff_schedule"][key] == want.diff_schedule[key], key
  for key in ("channels", "img_size", "variant"):
    assert got["model"][key] == want.model[key], key
  off = ae_i1k.get_config("variant=B/4,size=64")
  assert not off["latent_diffusion"] and off["diffusion_space"] == (64, 64, 3)
  assert off["diff_schedule"]["beta_schedule"] == "cosine"
  for bad in ("size=64,latent_diffusion=True",
              "size=128,latent_diffusion=True"):
    with pytest.raises(AssertionError):
      ae_i1k.get_config(bad)
    with pytest.raises(AssertionError):
      jconfig.get_config(bad)


def _jax_step(config, params, vae_params, jenc, capture, pre_latents=False):
  model = jax_model(config)
  tx, _ = joptim.adamw_trainer_tx(
      peak_lr=OPT["peak_lr"], batch_size=B, total_steps=OPT["total_steps"],
      warmup_steps=OPT["warmup_steps"], wd=OPT["wd"], betas=OPT["betas"],
      clip_norm=OPT["clip_norm"])
  cfg = dict(no_noise_prob=config["no_noise_prob"],
             mask_ratio=config["mask_ratio"],
             mask_ratio_no_noise=config["mask_ratio_no_noise"],
             use_labels=False, l2_metrics=True, _inject_draws=True,
             diffusion_space=LATENT, latent_diffusion=True,
             use_preprocessed_latents=pre_latents)
  mesh = parallel.make_mesh(jax.devices()[:1])
  jparams = jax.tree.map(jnp.asarray, params)
  state = {"params": jparams, "opt": tx.init(jparams),
           "rng": jax.random.PRNGKey(7),
           "gd": jgd.GaussianDiffusion.create("linear", T),
           "vae_params": jax.tree.map(jnp.asarray, vae_params)}
  sharding = jax.tree.map(lambda _: parallel.replicated_sharding(mesh),
                          state)
  update = jtrain.make_update_fn(model, tx, cfg, None, mesh, sharding,
                                 vae_encode=jenc)
  return state, update


def _port_step(config, params, vae):
  vparams, enc, _, _, _ = vae
  model = torch_model(config, params, trainable=True)
  names = [n for n, _ in train_ae.named_params(model)]
  opt = train_ae.make_optimizer(config, names, OPT["total_steps"],
                                OPT["warmup_steps"])
  state = train_ae.init_train_state(model, opt, config, device="cpu")
  state["vae_params"] = vparams
  return names, state, train_ae.make_update_fn(model, opt, config, None,
                                               vae_encode=enc)


def test_latent_training_step_matches_jax(vae, monkeypatch):
  """One step with the VAE encode inside: loss and gradients within the
  bounds of the pixel step's f32 test (tests/test_torch_train_step.py)."""
  cap = install_capture(monkeypatch)
  config = latent_config()
  params = convert.init_params(config, seed=3)
  rng, images, vae_noise = _inputs(11)
  n_noise = B - int(B * config["no_noise_prob"])
  t = rng.integers(0, T, (n_noise,)).astype(np.int32)
  noise = rng.standard_normal((n_noise,) + LATENT).astype(np.float32)
  jenc, _ = jax_vae_fns(vae[3], jnp.asarray(vae_noise))
  jstate, jupdate = _jax_step(config, params, vae[4], jenc, cap)
  keys = jax.random.split(jax.random.PRNGKey(1000), 6)
  jbatch = {"image": images, "_t": t, "_noise": noise}
  for name, key in zip(("_rng_mae", "_cfg_mae", "_mae_mae", "_rng_dit",
                        "_mae_dit", "_cfg_dit"), keys):
    jbatch[name] = key
  jstate, jmeas = jupdate.with_l2(jstate, jbatch)
  jax.effects_barrier()

  names, tstate, tupdate = _port_step(config, params, vae)
  draws = {"t": t.astype(np.int64), "noise": noise, "vae_noise": vae_noise,
           "mae_noise": cap.uniforms[config["mask_ratio_no_noise"]],
           "dit_noise": cap.uniforms[config["mask_ratio"]]}
  tmeas = tupdate(tstate, {"image": images}, draws, with_l2=True)
  np.testing.assert_allclose(float(tmeas["training_loss"]),
                             float(jmeas["training_loss"]), rtol=1e-5)
  np.testing.assert_allclose(float(tmeas["l2_grads"]),
                             float(jmeas["l2_grads"]), rtol=1e-4)
  jnu = joptim.find_states(jstate["opt"], optax.ScaleByAdamState)[0].nu
  check_step1_grads(names, (jax.device_get(jmeas), tmeas, flat(jnu),
                            tstate["opt"]["nu"]), 2e-5)
  # The VAE is frozen: its parameters leave the step as they came.
  for name, p in tstate["vae_params"].items():
    np.testing.assert_array_equal(p.numpy(), vae[0][name].numpy(), name)


def test_preprocessed_latents_skip_the_encode(vae):
  """With `use_preprocessed_latents` the batch carries latents: a step on
  the latents that the encoding step makes gives the same loss and
  gradients, bit for bit, and the VAE is not called."""
  config = latent_config()
  params = convert.init_params(config, seed=3)
  rng, images, vae_noise = _inputs(12)
  n_noise = B - int(B * config["no_noise_prob"])
  draws = {"t": rng.integers(0, T, (n_noise,)),
           "noise": rng.standard_normal((n_noise,) + LATENT).astype(
               np.float32),
           "mae_noise": rng.random((B - n_noise, 16), dtype=np.float32),
           "dit_noise": rng.random((n_noise, 16), dtype=np.float32)}
  _, state, update = _port_step(config, params, vae)
  loss, grads = update.loss_and_grads(state, {"image": images},
                                      dict(draws, vae_noise=vae_noise))
  latents = vae[1](vae[0], torch.from_numpy(vae_noise),
                   torch.from_numpy(images))

  def no_encode(*_):
    raise AssertionError("the encode ran on preprocessed latents")
  pre = latent_config(pre_latents=True)
  model = torch_model(pre, params, trainable=True)
  names = [n for n, _ in train_ae.named_params(model)]
  opt = train_ae.make_optimizer(pre, names, 10, 1)
  pstate = train_ae.init_train_state(model, opt, pre, device="cpu")
  pupdate = train_ae.make_update_fn(model, opt, pre, None,
                                    vae_encode=no_encode)
  loss2, grads2 = pupdate.loss_and_grads(pstate, {"image": latents}, draws)
  assert float(loss2) == float(loss)
  for a, b in zip(grads, grads2):
    assert torch.equal(a, b)
  with pytest.raises(ValueError):
    train_ae.make_update_fn(model, opt, latent_config(), None)


@pytest.fixture(scope="module")
def eval_pair(vae):
  """(config, JAX eval fns, JAX state, port eval fns, port state, images,
  vae_noise) on one set of seeded weights."""
  config = latent_config()
  params = convert.init_params(config, seed=5)
  _, images, vae_noise = _inputs(13)
  vparams, enc, dec, jmodel, jvparams = vae
  jenc, jdec = jax_vae_fns(jmodel, jnp.asarray(vae_noise))
  jfns = {k: jax.jit(f) for k, f in jtrain.make_eval_fns(
      jax_model(config), config, vae_encode=jenc, vae_decode=jdec).items()}
  jstate = {"params": jax.tree.map(jnp.asarray, params),
            "rng": jax.random.PRNGKey(21),
            "gd": jgd.GaussianDiffusion.create("linear", T),
            "vae_params": jvparams}
  tfns = train_ae.make_eval_fns(torch_model(config, params), config,
                                vae_encode=enc, vae_decode=dec)
  tstate = {"gd": tgd.GaussianDiffusion.create("linear", T, device="cpu"),
            "vae_params": vparams,
            "generator": torch.Generator().manual_seed(0)}
  return config, jfns, jstate, tfns, tstate, images, vae_noise


# f32 on both sides through the tiny VAE (test_torch_vae.py: 1e-5 of the
# largest value), the model (tests/test_torch_models.py: 1e-5) and, for
# what is decoded, the decoder again.
EVAL_TOL = 2e-5


def test_eval_predict_matches_jax(eval_pair):
  config, jfns, jstate, tfns, tstate, images, vae_noise = eval_pair
  _, jout = jfns["predict"](jstate, {"image": jnp.asarray(images)})
  _, tout = tfns["predict"](tstate, {"image": torch.from_numpy(images)},
                            draws={"vae_noise": vae_noise})
  assert _rel(tout["pre_logits"], jout["pre_logits"]) <= EVAL_TOL


def test_eval_patch_decodes_and_resizes_the_mask(eval_pair, monkeypatch):
  config, jfns, jstate, tfns, tstate, images, vae_noise = eval_pair
  cap = install_capture(monkeypatch)
  jx0, jmask = jfns["patch"](jstate, {"image": jnp.asarray(images)})
  jax.effects_barrier()
  tx0, tmask = tfns["patch"](
      tstate, {"image": torch.from_numpy(images)},
      draws={"vae_noise": vae_noise,
             "mae_noise": cap.uniforms[config["mask_ratio_no_noise"]]})
  assert tx0.shape == (B, SIZE, SIZE, 3) and tmask.shape == (B, SIZE, SIZE, 1)
  np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
  assert 0 < float(tmask.mean()) < 1
  assert _rel(tx0, jx0) <= EVAL_TOL


def test_eval_loss_matches_jax(eval_pair):
  config, jfns, jstate, tfns, tstate, images, vae_noise = eval_pair
  want = jfns["loss"](jstate, {"image": jnp.asarray(images)})
  # The JAX function's draws under its key: (vae, t, noise).
  _, t_rng, noise_rng = jax.random.split(jstate["rng"], 3)
  t = np.asarray(jax.random.randint(t_rng, (B,), 0, T, jnp.int32))
  noise = np.asarray(jax.random.normal(noise_rng, (B,) + LATENT))
  got = tfns["loss"](tstate, {"image": torch.from_numpy(images)},
                     draws={"vae_noise": vae_noise, "t": t, "noise": noise})
  assert got[1].shape == (B, SIZE, SIZE, 3)  # x_t decoded to pixels
  assert _rel(got[0], want[0]) <= EVAL_TOL
  for g, w in zip(got[1:], want[1:]):  # x_t, pred_x0, pred_x0_eps decoded
    assert _rel(g, w) <= EVAL_TOL


def test_latent_sampler_decodes_before_the_uint8_clip(eval_pair):
  """A 4-step f32 `uncond_eps` call: the latent loop with the JAX loop's
  draws, then the decode, then the clip to uint8."""
  config, jfns, jstate, tfns, tstate, _, _ = eval_pair
  key = jax.random.PRNGKey(7)
  shape = (4,) + LATENT
  want = jfns["uncond_eps"](jstate, key)
  loop_key, _ = jax.random.split(key)
  got = tfns["uncond_eps"](tstate, torch.Generator().manual_seed(0),
                           noise=jax_loop_draws(loop_key, shape, 4))
  images = got["fid_samples"].numpy()
  assert images.dtype == np.uint8 and images.shape == (4, SIZE, SIZE, 3)
  off = np.abs(images.astype(int) - np.asarray(want["fid_samples"], int))
  # f32 latents agree to round-off (no clip of x0 on the linear schedule),
  # the decode adds its own: the truncating uint8 cast lands one level
  # apart only where a pixel sits at a level boundary.
  assert off.max() <= 1
  assert np.mean(off > 0) <= 0.01
  with pytest.raises(ValueError):
    tfns["uncond_eps"](tstate["gd"], torch.Generator())


def test_vae_params_survive_a_checkpoint(vae, tmp_path):
  """`vae_params` go into the checkpoint and come back on resume."""
  config = latent_config()
  names, state, _ = _port_step(config, convert.init_params(config, seed=3),
                               vae)
  state["vae_params"] = {k: v.clone() for k, v in vae[0].items()}
  mngr = ckpt_lib.make_manager(str(tmp_path))
  ckpt_lib.save(mngr, train_ae.checkpoint_state(state, names, Chrono()), 1)
  ckpt_lib.wait_until_finished(mngr)
  restored = ckpt_lib.restore(mngr)
  assert sorted(restored["vae_params"]) == sorted(vae[0])
  for v in state["vae_params"].values():
    v.zero_()
  train_ae.load_checkpoint_state(state, names, restored, Chrono())
  for name, v in state["vae_params"].items():
    np.testing.assert_array_equal(v.numpy(), vae[0][name].numpy(), name)


def test_latents_source_raises_and_names_the_routes():
  """The TFRecord latent source (read without TensorFlow) needs its
  files: without `pattern` it raises, naming the pattern and
  the arrays route with `use_preprocessed_latents`; a TFDS name still
  raises, naming the arrays route."""
  from small_vision_tpu_torch.data import core
  with pytest.raises(ValueError, match="arrays:") as e:
    core.get("latents", split="train")
  assert "pattern=" in str(e.value)
  assert "use_preprocessed_latents" in str(e.value)
  with pytest.raises(ValueError, match="arrays:"):
    core.get("imagenet2012", split="train")
