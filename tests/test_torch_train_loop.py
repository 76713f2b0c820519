"""The port's train loop and its helpers: `steps()` and `mae_mix_weight`
against the JAX package's, `train_and_evaluate` and the CLI on the CPU at
the `runlocal` size, and the NaN abort."""

import math

import pytest
import torch

from small_vision_tpu.train import train_ae as jtrain
from small_vision_tpu.utils import schedules as jschedules
from small_vision_tpu_torch import cli
from small_vision_tpu_torch.configs import ae_i1k
from small_vision_tpu_torch.train import train_ae
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
  assert len(lines) == 4 and lines[0].startswith("3 steps")


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
