"""Port parity: the few-shot linear probe (`evaluators/fewshot_lsr.py`) and
its config entry against the JAX package's.

The solver on the same features: both branches (`eigh(XᵀX)` for N ≥ D,
the kernel form `eigh(XXᵀ)` for D > N), the solved weights (which do not
depend on the signs of the eigenvectors) within 1e-3 of their largest
magnitude, f32 eigensolvers in another order on a system that l2_reg
keeps well conditioned; the accuracies exactly, on well-separated
features. Then the evaluator on a width-64 UMD with bridged weights on a
synthetic source of 4 classes: the representations of the real rows
(the device pp's draws, seeded 0 in the port and PRNGKey(0) in JAX, must
not matter: the probe's pp is deterministic), and the metrics by name and
value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_vision_tpu import parallel
from small_vision_tpu.configs import ae_i1k as jconfig
from small_vision_tpu.evaluators import fewshot_lsr as jfewshot
from small_vision_tpu_torch.configs import ae_i1k as tconfig
from small_vision_tpu_torch.evaluators import common as tcommon
from small_vision_tpu_torch.evaluators import fewshot_lsr as tfewshot
from test_torch_evaluators import _sides
from test_torch_models import TOL, _close


def _separated(n_per_class, classes, d, seed):
  rng = np.random.default_rng(seed)
  centres = rng.standard_normal((classes, d)) * 4.0
  y = np.repeat(np.arange(classes), n_per_class)
  x = centres[y] + rng.standard_normal((len(y), d)) * 0.3
  return x.astype(np.float32), y


@pytest.mark.parametrize("n_per_class,d", [(10, 16), (3, 64)],
                         ids=["n_ge_d", "d_gt_n"])
def test_solver_matches_jax(n_per_class, d):
  classes, l2_reg = 4, 2.0 ** 10
  x, y = _separated(n_per_class, classes, d, seed=d)
  x_te, y_te = _separated(25, classes, d, seed=d)  # the same centres
  x_te += np.random.default_rng(1).standard_normal(x_te.shape).astype(
      np.float32) * 0.3
  n, dd = x.shape[0], d + 1
  assert (n >= dd) == (n_per_class == 10)

  jcache = jfewshot._precompute_cache(jnp.asarray(x), jnp.asarray(y),
                                      classes)
  jw = (jcache["lhs"] * (1.0 / (jcache["eigs"] + l2_reg)).reshape(1, -1)
        ) @ jcache["rhs"]
  jacc = float(jfewshot._eig_fewshot_acc_fn(
      jcache, jnp.asarray(x_te), jnp.asarray(y_te), l2_reg))
  cache = tfewshot.precompute_cache(torch.from_numpy(x), torch.from_numpy(y),
                                    classes)
  assert cache["eigs"].shape == (min(n, dd),)
  w = tfewshot.solve(cache, l2_reg)
  acc = float(tfewshot.eig_fewshot_acc(cache, torch.from_numpy(x_te),
                                       torch.from_numpy(y_te), l2_reg))
  for key in ("mean", "std"):
    np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]),
                               rtol=1e-5)
  assert w.shape == (dd, classes)
  _close(w.numpy(), np.asarray(jw), 1e-3)
  assert acc == jacc == 1.0


def _mesh():
  return parallel.make_mesh(jax.devices()[:1])


SYN = dict(name="synthetic", img_size=16, num_classes=4)
PP = 'value_range(-1, 1)|keep("image", "label")'


def _probe_kw():
  return dict(batch_size=16, representation_layer="pre_logits",
              datasets={"syn": (dict(SYN, num_examples=96),
                                dict(SYN, num_examples=40), "train",
                                "validation")},
              shots=(2, 20), l2_reg=2.0 ** 10, pp_train=PP, pp_eval=PP,
              display_first=[("syn", 20)], num_seeds=2)


def test_evaluator_matches_jax():
  """96 training examples (24 a class; 20 shots x 4 classes = 80 rows is
  the N >= D branch at D = 65, 2 shots the kernel form) and 40 test
  examples, in batches of 16 (the last of each split padded). The
  representations within the f32 model tolerance of
  tests/test_torch_models.py, the labels exactly; each accuracy within one
  test example of JAX's (a representation that differs in its last bits
  may sit on the decision boundary)."""
  config, jfns, jstate, tfns, tstate = _sides()
  jev = jfewshot.Evaluator(jfns["predict"], mesh=_mesh(), **_probe_kw())
  config = dict(config, evals={"probe": dict(type="fewshot_lsr",
                                             **_probe_kw())})
  (name, tev, log_steps, prefix), = tcommon.from_config(config, tfns, "cpu")
  assert (name, log_steps, prefix) == ("probe", None, "probe/")

  args = _probe_kw()["datasets"]["syn"]
  for i in (0, 1):  # train, test
    jx, jy = jev._get_repr(jstate, jev._get_dataset(*args)[i])
    tx, ty = tev.get_repr(tstate, tev._get_dataset(*args)[i])
    assert tx.shape == jx.shape == (96 if i == 0 else 40, 64)
    np.testing.assert_array_equal(ty.numpy(), jy)
    _close(tx.numpy(), jx, TOL["float32"])

  want = list(jev.run(jstate))
  got = list(tev.run(tstate))
  assert [k for k, _ in got] == [k for k, _ in want] == [
      "z/syn_2shot-seed-0", "a/syn_20shot-seed-0",
      "z/syn_2shot-seed-1", "a/syn_20shot-seed-1"]
  for (_, g), (_, w) in zip(got, want):
    assert abs(g - w) <= 1.0 / 40 + 1e-9, (g, w)


def test_config_entry_matches_jax():
  """The `fewshot` entry of the default config, its cadence and the
  `eval_steps` knob over it, as the JAX config's (ml_collections there,
  plain dicts here)."""
  for arg in ("data=synthetic", "data=synthetic,eval_steps=500",
              "data=synthetic,no_noise_prob=0.0,size=32",
              "data=arrays:/data/x"):
    jev = jconfig.get_config(arg).evals["fewshot"].to_dict()
    tev = tconfig.get_config(arg)["evals"]["fewshot"]
    jev["datasets"] = {k: tuple(v) for k, v in jev["datasets"].items()}
    jev["display_first"] = [tuple(x) for x in jev["display_first"]]
    tev = dict(tev, shots=tuple(tev["shots"]),
               display_first=[tuple(x) for x in tev["display_first"]])
    assert tev == dict(jev, shots=tuple(jev["shots"])), arg
  assert "fewshot" not in tconfig.get_config("runlocal")["evals"]
  assert "fewshot" not in tconfig.get_config("eval_steps=-1")["evals"]
