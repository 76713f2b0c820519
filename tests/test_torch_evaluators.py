"""Port parity: the evaluation functions of `make_eval_fns`, the evaluators'
input pipeline and the first evaluators, against the JAX package's.

`predict`, `noised_predict`, `patch` and `loss` run on bridged weights (f32,
width 64, depth 2 + 1, 16 px) with the JAX functions' own draws injected:
the noise and the timesteps are what the JAX functions make from
`train_state["rng"]` (recomputed here with the same splits), the masking
uniforms are recovered as tests/test_torch_train_step.py recovers them.
`make_for_inference` is held against the JAX pipeline on the synthetic
source with a ragged last batch, and `diffusion_loss` / `mae_reconstruction`
against the JAX evaluators on the same train state and draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_vision_tpu import parallel
from small_vision_tpu.data import pipeline as jpipeline
from small_vision_tpu.data import synthetic as jsynthetic
from small_vision_tpu.evaluators import diffusion_loss as jdiffusion_loss
from small_vision_tpu.evaluators import mae_reconstruction as jmae
from small_vision_tpu.ops import diffusion as jgd
from small_vision_tpu.train import train_ae as jtrain
from small_vision_tpu_torch import convert
from small_vision_tpu_torch.data import core as tcore
from small_vision_tpu_torch.data import pipeline as tpipeline
from small_vision_tpu_torch.evaluators import common as tcommon
from small_vision_tpu_torch.train import train_ae
from test_torch_models import TOL, _close, jax_model, small_config
from test_torch_train_step import install_capture

B, SIZE, T = 6, 16, 1000
KEY = 7
PP_EVAL = 'value_range(-1, 1)|keep("image", "label")'


def _sides(labels=False):
  """(config, JAX eval fns + state, port eval fns + state) on the same
  weights."""
  config = small_config(labels=labels)
  params = convert.init_params(config, seed=11)
  jstate = {"params": jax.tree.map(jnp.asarray, params),
            "rng": jax.random.PRNGKey(KEY),
            "gd": jgd.GaussianDiffusion.create("cosine", T)}
  jfns = jtrain.make_eval_fns(jax_model(config), dict(config))
  model = train_ae.build_model(config, device="cpu", trainable=True)
  model.load_state_dict(convert.params_from_jax(params, model))
  names = [n for n, _ in train_ae.named_params(model)]
  opt = train_ae.make_optimizer(config, names, 10, 1)
  tstate = train_ae.init_train_state(model, opt, config, device="cpu")
  return config, jfns, jstate, train_ae.make_eval_fns(model, config), tstate


def _images(seed=3, b=B):
  rng = np.random.default_rng(seed)
  return rng.uniform(-1, 1, (b, SIZE, SIZE, 3)).astype(np.float32)


def _tbatch(images, **extra):
  return {"image": torch.from_numpy(images),
          **{k: torch.from_numpy(v) for k, v in extra.items()}}


def test_predict_matches_jax():
  _, jfns, jstate, tfns, tstate = _sides()
  images = _images()
  _, jout = jfns["predict"](jstate, {"image": jnp.asarray(images)})
  none, tout = tfns["predict"](tstate, _tbatch(images))
  assert none is None and tout["mask"] is None
  _close(tout["pre_logits"].float().numpy(),
         np.asarray(jout["pre_logits"], np.float32), TOL["float32"])


def test_noised_predict_matches_jax():
  _, jfns, jstate, tfns, tstate = _sides()
  images = _images()
  _, jout = jfns["noised_predict"](jstate, {"image": jnp.asarray(images)})
  noise_rng = jax.random.split(jstate["rng"])[1]  # as the JAX function
  noise = np.array(jax.random.normal(noise_rng, images.shape))
  _, tout = tfns["noised_predict"](tstate, _tbatch(images),
                                   draws={"noise": noise})
  _close(tout["pre_logits"].float().numpy(),
         np.asarray(jout["pre_logits"], np.float32), TOL["float32"])
  # Without injected draws it draws from a copy of the state's generator:
  # twice the same, and the training stream does not move.
  before = tstate["generator"].get_state()
  a = tfns["noised_predict"](tstate, _tbatch(images))[1]["pre_logits"]
  b = tfns["noised_predict"](tstate, _tbatch(images))[1]["pre_logits"]
  assert torch.equal(a, b)
  assert torch.equal(tstate["generator"].get_state(), before)


def test_patch_matches_jax(monkeypatch):
  cap = install_capture(monkeypatch)
  config, jfns, jstate, tfns, tstate = _sides()
  images = _images()
  jpred, jmask = jfns["patch"](jstate, {"image": jnp.asarray(images)})
  jax.effects_barrier()
  ratio = config["mask_ratio_no_noise"]
  tpred, tmask = tfns["patch"](tstate, _tbatch(images),
                               draws={"mae_noise": cap.uniforms[ratio]})
  assert tpred.shape == (B, SIZE, SIZE, 3) and tmask.shape == (B, SIZE, SIZE,
                                                              1)
  np.testing.assert_array_equal(tmask.float().numpy(),
                                np.asarray(jmask, np.float32))
  _close(tpred.numpy(), np.asarray(jpred), TOL["float32"])


def _jax_loss_draws(jstate, shape):
  _, t_rng, noise_rng = jax.random.split(jstate["rng"], 3)
  t = jax.random.randint(t_rng, (shape[0],), 0, T, jnp.int32)
  return {"t": np.array(t),
          "noise": np.array(jax.random.normal(noise_rng, shape))}


@pytest.mark.parametrize("labels", [False, True])
def test_loss_matches_jax(labels):
  _, jfns, jstate, tfns, tstate = _sides(labels=labels)
  images = _images()
  label = np.random.default_rng(4).integers(0, 1000, (B,))
  want = jfns["loss"](jstate, {"image": jnp.asarray(images),
                               "label": jnp.asarray(label)})
  got = tfns["loss"](tstate, _tbatch(images, label=label),
                     draws=_jax_loss_draws(jstate, images.shape))
  assert got[0].shape == (B,)
  for g, w in zip(got, want):  # loss, x_t, pred_x0, pred_x0_eps
    _close(g.numpy(), np.asarray(w), 10 * TOL["float32"])


def test_sample_fn_takes_a_train_state_and_its_ema():
  """Given a train state the sampler runs on its EMA weights, and leaves
  the model's own in place."""
  config = small_config(labels=True)
  config["ema_decay"] = 0.5
  config["num_samples_per_call"] = 2
  config["diff_schedule"]["sampling_timesteps"] = 2
  model = train_ae.build_model(config, device="cpu", trainable=True)
  model.load_state_dict(convert.params_from_jax(
      convert.init_params(config, seed=1), model))
  names = [n for n, _ in train_ae.named_params(model)]
  state = train_ae.init_train_state(model, train_ae.make_optimizer(
      config, names, 10, 1), config, device="cpu")
  fns = train_ae.make_eval_fns(model, config)
  gen = lambda: torch.Generator().manual_seed(0)
  same = fns["cond_eps"](state, gen())["fid_samples"]
  assert torch.equal(same, fns["cond_eps"](state["gd"], gen())["fid_samples"])
  with torch.no_grad():
    for e in state["ema_params"]:
      e.mul_(0.5)
  before = [p.detach().clone() for p in state["params"]]
  other = fns["cond_eps"](state, gen())["fid_samples"]
  assert not torch.equal(other, same)            # it ran on the EMA weights
  assert all(torch.equal(p, b) for p, b in zip(state["params"], before))
  assert torch.equal(fns["cond_eps"](state["gd"], gen())["fid_samples"],
                     same)                       # the model kept its own


def _mesh():
  return parallel.make_mesh(jax.devices()[:1])


def test_make_for_inference_matches_jax_with_a_ragged_last_batch():
  kw = dict(split="validation", img_size=8, num_examples=40)
  jiter, _, jsteps = jpipeline.make_for_inference(
      jsynthetic.DataSource(**kw), PP_EVAL, _mesh(), 16, num_workers=1)
  titer, device_pp, tsteps = tpipeline.make_for_inference(
      tcore.get("synthetic", **kw), PP_EVAL, 16)
  assert tsteps == jsteps == 3
  jbatches, tbatches = list(jiter()), list(titer())
  assert len(jbatches) == len(tbatches) == 3
  for jb, tb in zip(jbatches, tbatches):
    assert sorted(jb) == sorted(tb) == ["_id", "_mask", "image", "label"]
    for k in jb:
      np.testing.assert_array_equal(np.asarray(jb[k]), tb[k], err_msg=k)
      # (A JAX array holds the int64 labels and ids as int32.)
      assert np.asarray(jb[k]).dtype.kind == tb[k].dtype.kind, k
  np.testing.assert_array_equal(tbatches[-1]["_mask"],
                                [1.0] * 8 + [0.0] * 8)
  assert not tbatches[-1]["image"][8:].any()     # zero padding
  # The device pp keeps `_mask` and `_id` and scales the image.
  out = device_pp({k: torch.from_numpy(v) for k, v in tbatches[0].items()}, {})
  assert sorted(out) == ["_id", "_mask", "image", "label"]
  assert out["image"].dtype == torch.float32
  assert -1.0 <= float(out["image"].min()) and float(out["image"].max()) <= 1.0


EVAL_DATA = dict(name="synthetic", split="validation", img_size=SIZE,
                 num_examples=20)


def _eval_config(config, name, eval_type, pred, draws):
  config = dict(config)
  config["evals"] = {name: dict(
      type=eval_type, pred=pred, data=dict(EVAL_DATA), pp_fn=PP_EVAL,
      log_steps=4, cache_final=True, batch_size=8,
      pred_kw={"draws": draws})}
  return config


def test_diffusion_loss_evaluator_matches_jax():
  """20 examples in batches of 8: the last batch has 4 real rows, and the
  mean weights every real example alike."""
  config, jfns, jstate, tfns, tstate = _sides()
  want = dict(jdiffusion_loss.Evaluator(
      jfns["loss"], mesh=_mesh(), batch_size=8, data=dict(EVAL_DATA),
      pp_fn=PP_EVAL).run(jstate))
  draws = _jax_loss_draws(jstate, (8, SIZE, SIZE, 3))
  (name, evaluator, log_steps, prefix), = tcommon.from_config(
      _eval_config(config, "val", "diffusion_loss", "loss", draws), tfns,
      "cpu")
  assert (name, log_steps, prefix) == ("val", 4, "val/")
  assert evaluator.n_steps == 3
  got = dict(evaluator.run(tstate))
  assert sorted(got) == sorted(want)
  assert got["loss"] == pytest.approx(want["loss"], rel=1e-4)
  for key in ("image_x_t", "image_pred_x0", "image_pred_x0_eps"):
    assert got[key].shape == (8, SIZE, SIZE, 3)
    _close(got[key], np.asarray(want[key]), 10 * TOL["float32"])


def test_mae_reconstruction_evaluator_matches_jax(monkeypatch):
  cap = install_capture(monkeypatch)
  config, jfns, jstate, tfns, tstate = _sides()
  want = dict(jmae.Evaluator(
      jfns["patch"], mesh=_mesh(), batch_size=8, data=dict(EVAL_DATA),
      pp_fn=PP_EVAL, num_batches=2).run(jstate))
  jax.effects_barrier()
  draws = {"mae_noise": cap.uniforms[config["mask_ratio_no_noise"]]}
  (_, evaluator, _, _), = tcommon.from_config(
      _eval_config(config, "mae_val", "mae_reconstruction", "patch", draws),
      tfns, "cpu")
  evaluator.n_steps = 2  # as `num_batches=2`
  got = dict(evaluator.run(tstate))
  assert sorted(got) == sorted(want)
  assert got["masked_mse"] == pytest.approx(want["masked_mse"], rel=1e-4)
  for key in ("image_masked", "image_reconstruction"):
    _close(got[key], np.asarray(want[key]), 10 * TOL["float32"])


def test_from_config_is_loud_about_a_misspelt_key():
  config, _, _, tfns, _ = _sides()
  bad = _eval_config(config, "val", "diffusion_loss", "loss", None)
  bad["evals"]["val"]["num_batchs"] = 2
  with pytest.raises(ValueError, match="Bad config for evaluator 'val'.*"
                                       "num_batchs"):
    tcommon.from_config(bad, tfns, "cpu")
  bad = _eval_config(config, "val", "diffusion_loss", "los", None)
  with pytest.raises(ValueError, match="Unknown predict_fn 'los'"):
    tcommon.from_config(bad, tfns, "cpu")


@pytest.mark.parametrize("eval_type", ["fewshot_lsr", "classification", "fid",
                                       "inception"])
def test_from_config_names_the_slice_of_an_unported_evaluator(eval_type):
  config, _, _, tfns, _ = _sides()
  config = dict(config, evals={"probe": dict(type=eval_type)})
  with pytest.raises(NotImplementedError, match="evaluators slice"):
    tcommon.from_config(config, tfns, "cpu")


def test_mean_and_save_evaluators(tmp_path):
  from small_vision_tpu_torch.evaluators import mean, save
  _, _, _, tfns, tstate = _sides()
  per_example = lambda state, batch: {
      "ids": batch["_id"].float(), "ones": torch.ones_like(batch["_mask"])}
  got = dict(mean.Evaluator(per_example, device="cpu", batch_size=8,
                            data=dict(EVAL_DATA), pp_fn=PP_EVAL).run(tstate))
  assert got == {"ids": pytest.approx(9.5), "ones": pytest.approx(1.0)}
  ev = save.Evaluator(
      lambda state, batch: (batch["image"].mean(dim=(1, 2, 3)),),
      device="cpu", batch_size=8, data=dict(EVAL_DATA), pp_fn=PP_EVAL,
      outfile="dump.npz", workdir=str(tmp_path))
  assert dict(ev.run(tstate)) == {"saved_examples": 20}
  with np.load(tmp_path / "dump.npz") as dump:
    assert dump["inputs"].shape == (20, SIZE, SIZE, 3)
    np.testing.assert_allclose(dump["outputs"],
                               dump["inputs"].mean(axis=(1, 2, 3)), rtol=1e-5)
