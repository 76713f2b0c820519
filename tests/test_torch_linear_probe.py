"""Port parity: the linear probe (`small_vision_tpu_torch/train/linear_ae.py`,
`optim.LarsProbe`, `configs/ae_i1k_lp.py`) against the JAX package's.

The JAX trainer builds its step inside `train_and_evaluate`; the test
composes the same step from the JAX package's pieces (`LinearCLS`,
`optim.lars_probe_tx`, `optax.softmax_cross_entropy`) as
small_vision_tpu/train/linear_ae.py does. Inputs are drawn with numpy from
a seed. The backbone is the config's runlocal UMD (width 32, f32, 16 px),
its JAX attention in interpret mode, the port's on the CPU.
"""

import inspect
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from small_vision_tpu import optim as joptim
from small_vision_tpu.configs import ae_i1k_lp as jconfig
from small_vision_tpu.models import ae as jae
from small_vision_tpu.ops import diffusion as jgd
from small_vision_tpu.train import linear_ae as jlinear
from small_vision_tpu_torch import cli, convert, optim
from small_vision_tpu_torch.configs import ae_i1k_lp
from small_vision_tpu_torch.models import vae as tvae
from small_vision_tpu_torch.ops import diffusion as tgd
from small_vision_tpu_torch.train import linear_ae
from small_vision_tpu_torch.utils import checkpoint as ckpt_lib

WIDTH, CLASSES, B = 32, 10, 16


def _head(seed):
  rng = np.random.default_rng(seed)
  kernel = (rng.standard_normal((WIDTH, CLASSES)) / np.sqrt(WIDTH)).astype(
      np.float32)
  return kernel, np.zeros(CLASSES, np.float32)  # the zero-initialised bias


def _reps(seed, n=3):
  rng = np.random.default_rng(seed)
  # Features with a non-zero mean, as pre_logits have.
  return [(rng.standard_normal((B, WIDTH)) * 2 + 0.7).astype(np.float32)
          for _ in range(n)]


def _t(a):
  return torch.from_numpy(np.array(a))


def test_batch_norm_and_head_match_flax_over_three_batches():
  """LinearCLS in training mode over three batches: the logits and the
  running statistics (biased variance, momentum 0.9) after each; then in
  evaluation mode on the running statistics."""
  jmodel = jlinear.LinearCLS(num_classes=CLASSES)
  kernel, bias = _head(0)
  bias = bias + 0.1  # a non-zero bias, to see it added
  params = {"Dense_0": {"kernel": kernel, "bias": bias}}
  jstats = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, WIDTH)),
                       train=True)["batch_stats"]
  _, tstats = linear_ae.init_head(WIDTH, CLASSES, device="cpu")
  for rep in _reps(1):
    want, new = jmodel.apply({"params": params, "batch_stats": jstats}, rep,
                             train=True, mutable=["batch_stats"])
    jstats = new["batch_stats"]
    got, tstats = linear_ae.linear_cls([_t(kernel), _t(bias)], tstats,
                                       _t(rep), train=True)
    # f32: the same sums in another order, a few ulps of the largest value.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * np.abs(want).max())
    for k in ("mean", "var"):
      np.testing.assert_allclose(tstats[k].numpy(),
                                 np.asarray(jstats["bn"][k]), rtol=1e-6,
                                 atol=1e-6)
  # The flax running variance is the biased one: not BatchNorm1d's.
  torch_bn = torch.nn.BatchNorm1d(WIDTH, momentum=0.1, affine=False)
  for rep in _reps(1):
    torch_bn(_t(rep))
  assert not np.allclose(torch_bn.running_var.numpy(),
                         np.asarray(jstats["bn"]["var"]), rtol=1e-3)
  rep = _reps(2, 1)[0]
  want = jmodel.apply({"params": params, "batch_stats": jstats}, rep,
                      train=False)
  got, same = linear_ae.linear_cls([_t(kernel), _t(bias)], tstats, _t(rep),
                                   train=False)
  assert same is tstats
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                             atol=1e-5 * np.abs(want).max())


def test_lars_matches_optax_over_three_steps():
  """Three LARS steps against `optax.lars` on `lars_probe_tx`'s schedule,
  the bias starting at zero (trust ratio 1 at step 1), warm-up 2 steps."""
  kw = dict(batch_size=256, total_steps=10, warmup_steps=2)
  tx, lr = joptim.lars_probe_tx(base_lr=0.1, **kw)
  opt = optim.LarsProbe(base_lr=0.1, **kw)
  kernel, bias = _head(3)
  jparams = {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}
  jstate = tx.init(jparams)
  tparams = [_t(kernel), _t(bias)]
  tstate = opt.init(tparams)
  rng = np.random.default_rng(4)
  for step in range(3):
    assert opt.lr(step) == pytest.approx(float(lr(step)), rel=1e-7)
    g = [rng.standard_normal(kernel.shape).astype(np.float32),
         rng.standard_normal(bias.shape).astype(np.float32)]
    updates, jstate = tx.update({"kernel": jnp.asarray(g[0]),
                                 "bias": jnp.asarray(g[1])}, jstate, jparams)
    jparams = optax.apply_updates(jparams, updates)
    opt.step(tparams, [_t(a) for a in g], tstate)
    for t, name in zip(tparams, ("kernel", "bias")):
      # The same f32 operations in the same order; the norms' sums may
      # round apart by an ulp.
      np.testing.assert_allclose(t.numpy(), np.asarray(jparams[name]),
                                 rtol=1e-6, atol=1e-9)
  assert tstate["count"] == 3
  assert np.abs(tparams[1].numpy()).max() > 0  # the bias moved


@pytest.fixture(scope="module")
def backbone():
  """The runlocal lp config's UMD, seeded, on both sides."""
  config = ae_i1k_lp.get_config("runlocal,size=16,data=synthetic")
  params = convert.init_params(config, seed=6)
  jmodel = jae.Model(**{"scan": False, **config["model"],
                        "attn_impl": "pallas_interpret"})
  tmodel = linear_ae.load_frozen_backbone(config, None, device="cpu")
  tmodel.load_state_dict(convert.params_from_jax(params, tmodel))
  return config, jax.tree.map(jnp.asarray, params), jmodel, tmodel


def _jax_rep(jmodel, params, images, noise=None):
  """The JAX trainer's backbone_rep: t=0, or t=50 noised with `noise`."""
  b = images.shape[0]
  if noise is not None:
    t = jnp.full((b,), 50, jnp.int32)
    images = jgd.q_sample(jgd.GaussianDiffusion.create("cosine", 1000),
                          images, t, noise)
    t_in = t + 1
  else:
    t_in = jnp.zeros((b,), jnp.int32)
  _, out = jmodel.apply({"params": params}, images, t=t_in, train=False)
  return np.asarray(out["pre_logits"])


@pytest.mark.parametrize("noised", [False, True])
def test_backbone_rep_matches_jax(backbone, noised):
  config, params, jmodel, tmodel = backbone
  config = dict(config, use_noised_pred=noised)
  rng = np.random.default_rng(7)
  images = rng.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
  noise = rng.standard_normal(images.shape).astype(np.float32)
  want = _jax_rep(jmodel, params, jnp.asarray(images),
                  jnp.asarray(noise) if noised else None)
  _, _, rep = linear_ae.make_fns(tmodel, config, None, None)
  state = {"gd": tgd.GaussianDiffusion.create("cosine", 1000, device="cpu")}
  got = rep(state, _t(images), _t(noise) if noised else None)
  # f32 model: tests/test_torch_models.py's 1e-5 of the largest value.
  np.testing.assert_allclose(got.numpy(), want, rtol=0,
                             atol=1e-5 * np.abs(want).max())


def test_probe_step_matches_jax(backbone):
  """Two update steps of the port's probe against the JAX trainer's step,
  composed from its pieces; the device pp's flip is injected as "no flip"
  on both sides."""
  config, params, jmodel, tmodel = backbone
  jhead = jlinear.LinearCLS(num_classes=CLASSES)
  tx, _ = joptim.lars_probe_tx(base_lr=0.1, batch_size=B, total_steps=6,
                               warmup_steps=1)
  opt = optim.LarsProbe(base_lr=0.1, batch_size=B, total_steps=6,
                        warmup_steps=1)
  kernel, bias = _head(8)
  hp = {"Dense_0": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}
  jstats = {"bn": {"mean": jnp.zeros(WIDTH), "var": jnp.ones(WIDTH)}}
  jopt = tx.init(hp)
  update, _, _ = linear_ae.make_fns(tmodel, config, None, opt)
  params_t, stats = [_t(kernel), _t(bias)], linear_ae.init_head(
      WIDTH, CLASSES, device="cpu")[1]
  state = {"params": params_t, "opt": opt.init(params_t),
           "batch_stats": stats, "generator": torch.Generator(),
           "gd": tgd.GaussianDiffusion.create("cosine", 1000, device="cpu")}
  rng = np.random.default_rng(9)
  for _ in range(2):
    images = rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, CLASSES, B)
    onehot = np.eye(CLASSES, dtype=np.float32)[labels]
    rep = _jax_rep(jmodel, params, jnp.asarray(images))

    def loss_fn(p):
      logits, new = jhead.apply({"params": p, "batch_stats": jstats}, rep,
                                mutable=["batch_stats"], train=True)
      return (optax.softmax_cross_entropy(logits, onehot).mean(),
              new["batch_stats"])
    (jloss, jstats), grads = jax.value_and_grad(loss_fn, has_aux=True)(hp)
    updates, jopt = tx.update(grads, jopt, hp)
    hp = optax.apply_updates(hp, updates)
    meas = update(state, {"image": images, "labels": onehot})
    np.testing.assert_allclose(float(meas["training_loss"]), float(jloss),
                               rtol=1e-5)
    for t, name in zip(state["params"], ("kernel", "bias")):
      want = np.asarray(hp["Dense_0"][name])
      np.testing.assert_allclose(t.numpy(), want, rtol=0,
                                 atol=1e-5 * np.abs(want).max())
    for k in ("mean", "var"):
      np.testing.assert_allclose(state["batch_stats"][k].numpy(),
                                 np.asarray(jstats["bn"][k]), rtol=1e-5,
                                 atol=1e-6)


def test_config_matches_jax():
  for arg in ("variant=L/2,size=64", "runlocal,data=synthetic",
              "data=synthetic,use_noised_pred=True", "data=imagenet2012"):
    want, got = jconfig.get_config(arg), ae_i1k_lp.get_config(arg)
    for key in ("num_classes", "width", "peak_lr", "wd", "use_noised_pred",
                "diffusion_space", "size"):
      assert tuple(np.atleast_1d(got[key])) == tuple(
          np.atleast_1d(want[key])), (arg, key)
    assert got["input"]["pp"] == want.input.pp, arg
    assert got["input"]["batch_size"] == want.input.batch_size, arg
    assert sorted(got["evals"]) == sorted(want.evals), arg
    for name, ev in got["evals"].items():
      assert ev["pp_fn"] == want.evals[name].pp_fn
      assert ev["data"]["split"] == want.evals[name].data.split
    assert got["model"] == dict(want.model), arg
  # The port's entry points run on the card unless the caller asks.
  for fn in (linear_ae.train_and_evaluate, linear_ae.load_frozen_backbone,
             linear_ae.init_head, tvae.load_vae):
    assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def _stop_after(step):
  """A `log` callback that ends a probe run when step `step + 1` reports,
  once the checkpoint of step `step` has been written."""
  class Stopped(Exception):
    pass

  def log(line):
    if line.startswith(f"probe step {step + 1}/"):
      for t in threading.enumerate():
        if t.name == ckpt_lib.WRITER_THREAD:
          t.join()
      raise Stopped
  return log, Stopped


def test_cli_runlocal_probe_resumes_from_its_checkpoint(tmp_path, capsys):
  """`cli --main lp_ae` on the runlocal config (6 steps, a probe checkpoint
  every 3): a run stopped after step 3 and resumed by the CLI ends with
  the head, LARS trace and statistics of the straight run, bit for bit."""
  spec = "ae_i1k_lp.py:runlocal,size=16,data=synthetic"
  straight = str(tmp_path / "straight")
  cli.main(["--main", "lp_ae", "--config", spec, "--device", "cpu",
            "--workdir", straight])
  rows = [json.loads(line) for line in
          open(os.path.join(straight, "sv_tpu_metrics.txt"))]
  losses = [r["training_loss"] for r in rows if "training_loss" in r]
  assert len(losses) == 6 and np.isfinite(losses).all()

  stopped = str(tmp_path / "stopped")
  log, Stopped = _stop_after(3)
  with pytest.raises(Stopped):
    linear_ae.train_and_evaluate(ae_i1k_lp.get_config(spec.split(":")[1]),
                                 stopped, device="cpu", log=log)
  capsys.readouterr()
  cli.main(["--main", "lp_ae", "--config", spec, "--device", "cpu",
            "--workdir", stopped])
  out = capsys.readouterr().out
  assert "Probe resumed from step 3" in out and "probe step 4/6" in out
  assert "probe step 3/6" not in out
  a, b = (ckpt_lib.restore(ckpt_lib.make_manager(os.path.join(w, "probe")))
          for w in (straight, stopped))
  for entry in ("params", "opt", "batch_stats"):
    fa = dict(ckpt_lib.tree_flatten_with_names(a[entry]))
    fb = dict(ckpt_lib.tree_flatten_with_names(b[entry]))
    assert sorted(fa) == sorted(fb)
    for name in fa:
      assert torch.equal(torch.as_tensor(fa[name]),
                         torch.as_tensor(fb[name])), (entry, name)
