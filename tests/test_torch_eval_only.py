"""Port parity: the eval-only config and tool (`configs/eval_ae_i1k.py`,
`tools/eval_only.py`) against the JAX package's.

  - The config dict against JAX's for `runlocal`, `transfer=True` and
    `transfer_root` (and the defaults): force_eval, a 0-step run without
    `total_epochs`, no checkpoint written, the sampler's timesteps, every
    sampling evaluator's `total_samples`, the transfer entry (its ten
    datasets rewired to `arrays:` by `transfer_root`, 2 shots at
    runlocal) and the model.
  - `eval_only.main` on a tiny port checkpoint (runlocal, 16 px, one
    training step) over tests/test_eval_only_transfer.py's stand-ins (ten
    `arrays` datasets of 4-13 colour-offset classes, 6 training and 3
    test images a class): every dataset's 2-shot accuracy is logged,
    finite, at least chance; the checkpoint's step is the one evaluated
    (not a fresh init); and the accuracies of three of the datasets (4, 7
    and 13 classes: JAX compiles the probe per dataset, which the suite's
    time cannot afford ten times) match the JAX `fewshot_lsr` evaluator
    run on the same weights (the checkpoint's parameters, flax names)
    within one example of that dataset's test split (a representation
    that differs in its last bits may sit on the decision boundary).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_models import jax_model

from small_vision_tpu import parallel as jparallel
from small_vision_tpu.cli import parse_config as jparse_config
from small_vision_tpu.evaluators import fewshot_lsr as jfewshot
from small_vision_tpu.ops import diffusion as jgd
from small_vision_tpu.train import train_ae as jtrain
from small_vision_tpu_torch.configs import eval_ae_i1k, parse_config
from small_vision_tpu_torch.data.arrays import write_arrays
from small_vision_tpu_torch.tools import eval_only
from small_vision_tpu_torch.train import train_ae
from small_vision_tpu_torch.utils import checkpoint as ckpt_lib
from small_vision_tpu_torch.utils.trees import (recover_tree,
                                                tree_flatten_with_names)

NUM_CLASSES = {name: 4 + i for i, name in
               enumerate(eval_ae_i1k.TRANSFER_DATASETS)}
PER_CLASS = {"train": 6, "validation": 3}
JAX_HELD = ("imagenet", "food101", "sun397")


def _plain(x):
  """ml_collections and tuples as plain dicts and lists."""
  if hasattr(x, "to_dict"):
    x = x.to_dict()
  if isinstance(x, dict):
    return {k: _plain(v) for k, v in x.items()}
  if isinstance(x, (list, tuple)):
    return [_plain(v) for v in x]
  return x


@pytest.mark.parametrize("arg", [
    "", "runlocal=True,transfer=True,size=16",
    "transfer=True,transfer_root=/data/t,size=16",
    "runlocal=True,transfer=True,transfer_root=/data/t,size=16,"
    "use_labels=False,data=arrays:/data/t/imagenet",
    "sampling_timesteps=50,total_samples=256,data=arrays:/x"])
def test_config_matches_jax(arg):
  got, want = parse_config(f"eval_ae_i1k.py:{arg}"), jparse_config(
      f"eval_ae_i1k.py:{arg}")
  for key in ("force_eval", "total_steps", "save_ckpt", "diff_schedule",
              "model", "num_classes", "use_labels"):
    assert _plain(got[key]) == _plain(want[key]), (arg, key)
  assert got["input"]["batch_size"] == want.input.batch_size
  assert _plain(got["input"]["data"]) == _plain(want.input.data)
  assert "total_epochs" not in got and "total_epochs" not in want
  assert got["force_eval"] and got["total_steps"] == 0
  assert sorted(got["evals"]) == sorted(want.evals), arg
  for name, ev in got["evals"].items():
    if name.startswith("sample"):
      assert ev["total_samples"] == want.evals[name]["total_samples"]
  if "transfer=True" in arg:
    assert _plain(got["evals"]["transfer"]) == _plain(
        want.evals["transfer"]), arg
    if "transfer_root" in arg:
      for name, spec in got["evals"]["transfer"]["datasets"].items():
        assert spec == (f"arrays:/data/t/{name}",) * 2 + (
            "train", "validation")


@pytest.fixture(scope="module")
def transfer_root(tmp_path_factory):
  """tests/test_eval_only_transfer.py's stand-ins: class c of a dataset
  of nc classes is noise in [0, 40) offset by c * (200 // nc)."""
  root = tmp_path_factory.mktemp("transfer_arrays")
  rng = np.random.default_rng(0)
  for name, nc in NUM_CLASSES.items():
    for split, n_per in PER_CLASS.items():
      labels = np.repeat(np.arange(nc), n_per)
      imgs = (rng.integers(0, 40, (nc * n_per, 16, 16, 3))
              + labels[:, None, None, None] * (200 // nc)
              ).clip(0, 255).astype(np.uint8)
      write_arrays(str(root / name / split), imgs, labels.astype(np.int64))
  return str(root)


def test_eval_only_matches_jax_fewshot(transfer_root, tmp_path):
  workdir = str(tmp_path / "run")
  data = f"data=arrays:{transfer_root}/imagenet"
  train = parse_config(f"ae_i1k.py:runlocal,size=16,{data},total_steps=1,"
                       "ckpt_steps=1,eval_steps=-1")
  train["input"]["num_workers"] = 1
  train_ae.train_and_evaluate(train, workdir, device="cpu",
                              log=lambda s: None)
  spec = (f"eval_ae_i1k.py:runlocal=True,transfer=True,"
          f"transfer_root={transfer_root},size=16,use_labels=False,{data}")
  eval_only.main(["--config", spec, "--workdir", workdir,
                  "--device", "cpu"])

  with open(os.path.join(workdir, "sv_tpu_metrics.txt")) as f:
    rows = [json.loads(line) for line in f if line.strip()]
  evaluated = [r for r in rows if any(k.startswith("transfer/") for k in r)]
  assert len(evaluated) == 1 and evaluated[0]["step"] == 1
  got = {k: v for k, v in evaluated[0].items() if k.startswith("transfer/")}

  # The JAX evaluator on the checkpoint's weights.
  config = parse_config(spec)
  mngr = ckpt_lib.make_manager(workdir, writer=False)
  flat = dict(tree_flatten_with_names(ckpt_lib.restore_subtree(
      mngr, "params")))
  params = recover_tree(list(flat), [jnp.asarray(t.numpy())
                                     for t in flat.values()])
  kw = dict(config["evals"]["transfer"])
  for key in ("type", "pred", "log_steps"):
    kw.pop(key)
  kw["datasets"] = {k: v for k, v in kw["datasets"].items() if k in JAX_HELD}
  jev = jfewshot.Evaluator(
      jtrain.make_eval_fns(jax_model(config), dict(config))["predict"],
      mesh=jparallel.make_mesh(jax.devices()[:1]),
      batch_size=config["input"]["batch_size"], **kw)
  want = dict(jev.run({"params": params, "rng": jax.random.PRNGKey(0),
                       "gd": jgd.GaussianDiffusion.create("cosine", 1000)}))
  for name, nc in NUM_CLASSES.items():
    key = f"{name}_2shot-seed-0"
    (gk,) = [k for k in got if k.endswith(key)]
    acc = got[gk]
    assert np.isfinite(acc) and 1.0 / nc <= acc <= 1.0, (name, acc)
    if name not in JAX_HELD:
      continue
    (wk,) = [k for k in want if k.endswith(key)]
    assert gk == "transfer/" + wk
    assert abs(acc - float(want[wk])) <= 1.0 / (nc * PER_CLASS[
        "validation"]) + 1e-9, (name, acc, want[wk])
