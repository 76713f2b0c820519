"""The port's train loop and its helpers: `steps()` and `mae_mix_weight`
against the JAX package's, `train_and_evaluate` and the CLI on the CPU at
the `runlocal` size, the NaN abort, and the loop's substrate: the log
cadence, the metrics file, checkpoints with a bit-equal resume, the warm
start, the finetune surgery and `force_eval`."""

import json
import math
import os
import threading

import pytest
import torch

from small_vision_tpu.train import train_ae as jtrain
from small_vision_tpu.utils import schedules as jschedules
from small_vision_tpu_torch import cli
from small_vision_tpu_torch.configs import ae_i1k
from small_vision_tpu_torch.train import train_ae
from small_vision_tpu_torch.utils import checkpoint as ckpt_lib
from small_vision_tpu_torch.utils import schedules


@pytest.mark.parametrize("config,args", [
    ({"total_steps": 20}, (50_000, 256)),
    ({"total_epochs": 800}, (50_000, 1024)),
    ({"total_examples": 1000}, (None, 256)),
    ({"warmup_percent": 0.05}, (None, None, 1000)),
])
def test_steps_matches_jax(config, args):
  prefix = next(iter(config)).split("_")[0]
  assert schedules.steps(prefix, config, *args) == \
      jschedules.steps(prefix, config, *args)


def test_steps_raises_on_ambiguous_or_missing():
  with pytest.raises(ValueError, match="Ambiguous"):
    schedules.steps("total", {"total_steps": 1, "total_epochs": 2}, 10, 2)
  with pytest.raises(ValueError, match="Missing"):
    schedules.steps("total", {})
  assert schedules.steps("warmup", {}, default=None) is None


@pytest.mark.parametrize("b,p", [(256, 0.5), (8, 0.5), (7, 0.5), (10, 0.33),
                                 (4, 0.0)])
def test_mae_mix_weight_matches_jax(b, p):
  assert train_ae.mae_mix_weight(b, p) == jtrain.mae_mix_weight(b, p)


def _runlocal(steps=3, log_steps=1):
  return ae_i1k.get_config(
      f"runlocal,size=16,data=synthetic,total_steps={steps},"
      f"log_steps={log_steps}")


def test_train_and_evaluate_on_cpu():
  lines = []
  state, history = train_ae.train_and_evaluate(_runlocal(), device="cpu",
                                               log=lines.append)
  assert [h["step"] for h in history] == [1, 2, 3]
  assert all(math.isfinite(h["training_loss"]) for h in history)
  # Step 1 runs at learning rate 0 (warm-up starts at 0); later steps move.
  assert history[0]["l2_updates"] == 0.0
  assert history[-1]["l2_updates"] > 0.0
  assert history[-1]["l2_params"] != history[0]["l2_params"]
  assert state["opt"]["count"] == 3
  assert all(m.dtype == torch.bfloat16 for m in state["opt"]["mu"])
  assert lines[0].startswith("3 steps")
  assert [l.split(":")[0] for l in lines if l.startswith("step ")] == [
      "step 1/3", "step 2/3", "step 3/3"]
  assert "NOTE: Starting at step 1/3" in lines


def test_train_and_evaluate_aborts_on_nan(monkeypatch):
  make = train_ae.make_update_fn

  def nan_update_fn(*args, **kw):
    update_fn = make(*args, **kw)

    def wrapped(*a, **k):
      out = update_fn(*a, **k)
      out["training_loss"] = torch.tensor(float("nan"))
      return out
    return wrapped

  monkeypatch.setattr(train_ae, "make_update_fn", nan_update_fn)
  with pytest.raises(RuntimeError, match="NaN"):
    train_ae.train_and_evaluate(_runlocal(steps=2), device="cpu",
                                log=lambda s: None)


def test_cli_trains_on_cpu(capsys):
  cli.main(["--config",
            "ae_i1k.py:runlocal,size=16,data=synthetic,total_steps=2",
            "--device", "cpu"])
  out = capsys.readouterr().out
  assert "step 2/2" in out and "img/s at batch 32 on cpu" in out


def test_cli_does_not_fall_back_to_the_cpu(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(SystemExit, match="no CUDA device"):
    cli.main(["--config", "ae_i1k.py:runlocal,total_steps=1"])


def test_config_refuses_other_data():
  with pytest.raises(ValueError, match="synthetic"):
    ae_i1k.get_config("data=imagenet2012")


def test_log_cadence_is_the_jax_predicate():
  """A periodic log step within a quarter period of the end is dropped:
  with 9 steps and a period of 8 the loop logs at steps 1 and 9 only."""
  _, history = train_ae.train_and_evaluate(_runlocal(steps=9, log_steps=8),
                                           device="cpu", log=lambda s: None)
  assert [h["step"] for h in history if "training_loss" in h] == [1, 9]
  assert [h["step"] for h in history] == list(range(1, 10))


PP_EVAL = 'value_range(-1, 1)|keep("image", "label")'


def _with_substrate(steps=8, extra=""):
  """runlocal at 16 px: a checkpoint every 4 steps, `val` and `mae_val` on
  70 validation examples (the last batch is ragged) every 4 steps."""
  config = ae_i1k.get_config(
      f"runlocal,size=16,data=synthetic,total_steps={steps},log_steps=1,"
      f"ckpt_steps=4{extra}")
  data = dict(name="synthetic", split="validation", img_size=16,
              num_examples=70)
  ev = dict(data=data, pp_fn=PP_EVAL, log_steps=4, cache_final=True)
  config["evals"] = {
      "val": dict(type="diffusion_loss", pred="loss", **ev),
      "mae_val": dict(type="mae_reconstruction", pred="patch", **ev)}
  return config


class _Stopped(Exception):
  pass


def _stop_at(step):
  """A `log` that ends the run when `step` reports, as a crash would, once
  the checkpoint before it has been written."""
  def log(line):
    if line.startswith(f"step {step}/"):
      for t in threading.enumerate():
        if t.name == ckpt_lib.WRITER_THREAD:
          t.join()
      raise _Stopped
  return log


def _rows(workdir):
  return [json.loads(l) for l in open(os.path.join(workdir,
                                                   "sv_tpu_metrics.txt"))]


def test_resume_is_bit_equal_to_a_straight_run(tmp_path):
  dir_a, dir_b = str(tmp_path / "a"), str(tmp_path / "b")
  state_a, hist_a = train_ae.train_and_evaluate(
      _with_substrate(), dir_a, device="cpu", log=lambda s: None)
  assert [h["step"] for h in hist_a] == list(range(1, 9))

  with pytest.raises(_Stopped):
    train_ae.train_and_evaluate(_with_substrate(), dir_b, device="cpu",
                                log=_stop_at(5))
  assert os.listdir(os.path.join(dir_b, "checkpoints")) == ["4"]
  lines = []
  state_b, hist_b = train_ae.train_and_evaluate(
      _with_substrate(), dir_b, device="cpu", log=lines.append)
  assert "NOTE: Resumed from step 4" in lines
  assert "NOTE: Starting at step 5/8" in lines
  assert [h["step"] for h in hist_b] == [5, 6, 7, 8]

  for key in ("params",):
    assert all(torch.equal(a, b)
               for a, b in zip(state_a[key], state_b[key])), key
  for key in ("mu", "nu"):
    assert all(torch.equal(a, b) for a, b in
               zip(state_a["opt"][key], state_b["opt"][key])), key
  assert state_a["opt"]["count"] == state_b["opt"]["count"] == 8
  assert torch.equal(state_a["generator"].get_state(),
                     state_b["generator"].get_state())

  # The metrics file is continuous over the restart, and the resumed run's
  # losses and evaluations are the straight run's.
  rows_a, rows_b = _rows(dir_a), _rows(dir_b)
  assert [r["step"] for r in rows_a] == list(range(1, 9))
  assert [r["step"] for r in rows_b] == list(range(1, 9))
  by_step = lambda rows: {r["step"]: r for r in rows}
  for step in range(1, 9):
    for key in ("training_loss", "l2_params"):
      assert by_step(rows_a)[step][key] == by_step(rows_b)[step][key]
  for step in (4, 8):
    row = by_step(rows_a)[step]
    assert math.isfinite(row["val/loss"])
    assert math.isfinite(row["mae_val/masked_mse"])
    assert row["val/loss"] == by_step(rows_b)[step]["val/loss"]
  assert any("z/img_per_sec" in r for r in rows_a)
  assert "model" in json.load(open(os.path.join(dir_a, "config.json")))
  assert sorted(os.listdir(os.path.join(dir_a, "checkpoints"))) == ["8"]
  grids = os.listdir(os.path.join(dir_a, "grids"))
  assert "val_image_x_t_8.npy" in grids
  assert "mae_val_image_reconstruction_4.npy" in grids

  # A third start finds the run complete: no step runs, the evaluators do.
  _, hist_c = train_ae.train_and_evaluate(
      _with_substrate(), dir_b, device="cpu", log=lambda s: None)
  assert hist_c == [] and _rows(dir_b)[-1]["step"] == 8


def test_force_eval_returns_after_one_evaluation(tmp_path):
  config = _with_substrate(extra="")
  config["force_eval"] = True
  lines = []
  state, history = train_ae.train_and_evaluate(
      config, str(tmp_path), device="cpu", log=lines.append)
  assert history == [] and state["opt"]["count"] == 0
  assert [l for l in lines if "evaluation" in l] == [
      "NOTE: val evaluation (forced)...",
      "NOTE: mae_val evaluation (forced)..."]
  (row,) = _rows(str(tmp_path))
  assert row["step"] == 0 and math.isfinite(row["val/loss"])
  assert not os.path.exists(tmp_path / "checkpoints" / "8")


def _labels_config(steps, **kw):
  config = ae_i1k.get_config(
      f"runlocal,size=16,data=synthetic,total_steps={steps},log_steps=1,"
      f"ckpt_steps=2,use_labels=True")
  config.update(kw)
  return config


def test_finetune_surgery_keeps_a_fresh_label_head_and_optimizer(tmp_path):
  workdir = str(tmp_path)
  pre, _ = train_ae.train_and_evaluate(_labels_config(2), workdir,
                                       device="cpu", log=lambda s: None)
  pre_params = [p.detach().clone() for p in pre["params"]]

  # A finetune run that takes no step shows what the surgery leaves.
  lines = []
  config = _labels_config(2, finetune=True, force_eval=True)
  fine, _ = train_ae.train_and_evaluate(config, workdir, device="cpu",
                                        log=lines.append)
  assert any(l.startswith("NOTE: Finetune surgery from") for l in lines)
  fresh = train_ae.setup_training(_labels_config(2), "cpu",
                                  log=lambda s: None)
  names = fresh["names"]
  assert any(n.startswith("label_embed/") for n in names)
  for n, got, trained, init in zip(names, fine["params"], pre_params,
                                   fresh["train_state"]["params"]):
    if n.split("/")[0] in ("label_embed", "label_trunk"):
      assert torch.equal(got, init), n       # the fresh label head
    else:
      assert torch.equal(got, trained), n    # the pretrain checkpoint's
  assert any(not torch.equal(t, i) for t, i in
             zip(pre_params, fresh["train_state"]["params"]))
  assert fine["opt"]["count"] == 0           # a fresh optimizer
  assert all(not m.any() for m in fine["opt"]["mu"])
  assert all(torch.equal(e, p) for e, p in
             zip(fine["ema_params"], fine["params"]))

  # A finetune run that trains writes under its own directory, and a second
  # start resumes from there, not from the pretrain checkpoint.
  train_ae.train_and_evaluate(_labels_config(2, finetune=True), workdir,
                              device="cpu", log=lambda s: None)
  assert os.listdir(os.path.join(workdir, "finetune", "checkpoints")) == ["2"]
  lines = []
  train_ae.train_and_evaluate(_labels_config(2, finetune=True), workdir,
                              device="cpu", log=lines.append)
  assert "NOTE: Resumed from step 2" in lines
  assert not any("surgery" in l for l in lines)


def test_model_init_warm_start_with_dont_load(tmp_path):
  config = _runlocal(steps=1)
  run = train_ae.setup_training(config, "cpu", log=lambda s: None)
  names = run["names"]
  donor = {n: torch.full_like(p, 0.25) for n, p in
           zip(names, run["train_state"]["params"])}
  path = str(tmp_path / "init.npz")
  ckpt_lib.save_params_npz(path, donor)

  config["model_init"] = path
  config["model_load"] = {"dont_load": ("head/.*", "cls")}
  config["force_eval"] = True  # no step: the state is the warm start's
  state, _ = train_ae.train_and_evaluate(config, device="cpu",
                                         log=lambda s: None)
  for n, p, init in zip(names, state["params"],
                        run["train_state"]["params"]):
    if n.startswith("head/") or n == "cls":
      assert torch.equal(p, init), n
    else:
      assert torch.equal(p, donor[n]), n

  config["model_load"] = {}
  del donor["cls"]
  ckpt_lib.save_params_npz(path, donor)
  with pytest.raises(ValueError, match="cls not found in checkpoint"):
    train_ae.train_and_evaluate(config, device="cpu", log=lambda s: None)


def test_cli_writes_a_workdir_and_resumes(tmp_path, capsys):
  spec = ("ae_i1k.py:runlocal,size=16,data=synthetic,total_steps=4,"
          "log_steps=1,ckpt_steps=2")
  workdir = str(tmp_path / "run")
  cli.main(["--config", spec, "--device", "cpu", "--workdir", workdir])
  assert [r["step"] for r in _rows(workdir)] == [1, 2, 3, 4]
  assert os.listdir(os.path.join(workdir, "checkpoints")) == ["4"]
  capsys.readouterr()
  spec6 = spec.replace("total_steps=4", "total_steps=6")
  cli.main(["--config", spec6, "--device", "cpu", "--workdir", workdir,
            "--cleanup"])
  out = capsys.readouterr().out
  assert "Resumed from step 4" in out and "step 5/6" in out
  assert "step 4/6" not in out
  assert not os.path.exists(workdir)          # --cleanup
  with pytest.raises(SystemExit, match="lp_ae"):
    cli.main(["--config", spec, "--device", "cpu", "--main", "lp_ae"])


def test_new_entry_points_default_to_the_gpu(monkeypatch):
  import inspect
  from small_vision_tpu_torch.evaluators import common as eval_common
  from small_vision_tpu_torch.tools import ablate_attention_kernel as tool
  from small_vision_tpu_torch.utils.chrono import Chrono
  for fn in (train_ae.train_and_evaluate, train_ae.setup_training,
             eval_common.from_config, Chrono.__init__):
    assert inspect.signature(fn).parameters["device"].default == "cuda", fn
  # The ablation tool times kernels: it neither runs on the CPU nor falls
  # back to it.
  with pytest.raises(SystemExit, match="on the GPU"):
    tool.main(["--device", "cpu"])
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(SystemExit, match="no CUDA device"):
    tool.main([])
  with pytest.raises(SystemExit, match="unknown variants"):
    tool.main(["--variants", "prod,fast"])
