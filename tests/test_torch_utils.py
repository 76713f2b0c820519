"""Port parity: the trainer's small utilities against the JAX package's:
`itstime` over a grid, `hms`, `make_grid`, `Chrono` under a fake clock
(warm-up, discounted pauses, save/load), the losses on numpy-seeded inputs,
and the `MetricWriter`'s rows for the same calls."""

import importlib
import itertools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from small_vision_tpu.utils import losses as jlosses
from small_vision_tpu.utils import metrics as jmetrics
from small_vision_tpu.utils import misc as jmisc
from small_vision_tpu_torch.utils import chrono, losses, metrics, misc

# `small_vision_tpu.utils.chrono` the attribute is the package's Chrono
# singleton; the module itself is what the import system holds.
jchrono = importlib.import_module("small_vision_tpu.utils.chrono")


@pytest.mark.parametrize("first,last", itertools.product([True, False],
                                                         repeat=2))
def test_itstime_matches_jax_over_a_grid(first, last):
  n = 0
  for every, total in itertools.product([0, 1, 3, 4, 100], [1, 7, 8, 101]):
    for step in range(1, total + 1):
      for drop in (0.25, 0, 0.5):
        want = jmisc.itstime(step, every, total, last=last, first=first,
                             drop_close_to_last=drop)
        got = misc.itstime(step, every, total, last=last, first=first,
                           drop_close_to_last=drop)
        assert got == want, (step, every, total, first, last, drop)
        n += 1
  assert n > 1000


def test_itstime_drops_a_hit_close_to_the_last_step():
  # |100 - 101| < 0.25 * 100: step 100 is not logged, step 101 is.
  assert not misc.itstime(100, 100, 101)
  assert misc.itstime(101, 100, 101)
  assert misc.itstime(1, 100, 101) and not misc.itstime(1, 100, 101,
                                                        first=False)


@pytest.mark.parametrize("seconds", [0, 0.4, 59.6, 61, 3599, 3600, 3725.2,
                                     90061])
def test_hms_matches_jax(seconds):
  assert misc.hms(seconds) == jmisc.hms(seconds)


@pytest.mark.parametrize("n,num_samples", [(5, 36), (36, 36), (40, 9)])
def test_make_grid_matches_jax(n, num_samples):
  images = np.random.default_rng(n).integers(0, 256, (n, 4, 6, 3),
                                             dtype=np.uint8)
  want = jmisc.make_grid(images, num_samples)
  np.testing.assert_array_equal(
      misc.make_grid(torch.from_numpy(images), num_samples), want)
  np.testing.assert_array_equal(
      misc.make_grid({"samples": images}, num_samples), want)


def test_log_timing_on_the_host():
  got = {}
  with misc.log_timing(got.__setitem__, "block", device="cpu"):
    pass
  assert 0 <= got["block"] < 1.0


class FakeClock:

  def __init__(self):
    self.now = 100.0

  def __call__(self):
    return self.now


def _chrono_pair(monkeypatch):
  """The port's Chrono and the JAX one on the same fake clock."""
  clock = FakeClock()
  monkeypatch.setattr(jchrono.time, "monotonic", clock)
  rows_t, rows_j = {}, {}
  ct = chrono.Chrono(device="cpu", clock=clock)
  cj = jchrono.Chrono()
  for c, rows in ((ct, rows_t), (cj, rows_j)):
    c.inform(first_step=0, total_steps=100, global_bs=32,
             steps_per_epoch=10.0, measure=rows.__setitem__)
  return clock, ct, cj, rows_t, rows_j


def _same_but_for_the_cores(rows_t, rows_j):
  """The same metrics; the per-core ones differ by the core count (one CPU
  device on the port's side, the JAX test platform's devices on the
  other), and the core-hours' name by the device kind."""
  per_core = lambda k: k.startswith(("z/core_hours_",
                                     "z/img_per_sec_per_core"))
  strip = lambda rows: {k: v for k, v in rows.items() if not per_core(k)}
  assert strip(rows_t) == strip(rows_j)
  cores = jchrono.jax.device_count()
  assert rows_t["z/img_per_sec_per_core"] == pytest.approx(
      rows_j["z/img_per_sec_per_core"] * cores)
  hours = lambda rows: [v for k, v in rows.items()
                        if k.startswith("z/core_hours_")]
  assert len(hours(rows_t)) == len(hours(rows_j)) == 1
  assert hours(rows_t)[0] == pytest.approx(hours(rows_j)[0] / cores)


def test_chrono_warmup_pause_and_rates_match_jax(monkeypatch):
  clock, ct, cj, rows_t, rows_j = _chrono_pair(monkeypatch)
  both = lambda f: (f(ct), f(cj))
  both(lambda c: c.tick(1))          # first tick: remembered, no timing
  assert rows_t == {}
  clock.now += 50.0                   # warm-up noise: never measured
  both(lambda c: c.tick(2))          # 1 step since: still warming up
  both(lambda c: c.tick(3))          # 2 steps since the first: timing starts
  assert rows_t == {} and ct.train_start_step == 3
  clock.now += 4.0
  both(lambda c: c.pause())
  clock.now += 30.0                   # a checkpoint or an evaluation
  both(lambda c: c.resume())
  clock.now += 4.0
  both(lambda c: c.tick(7))          # 4 steps in 8 s of training
  assert rows_t["z/secs_per_step"] == pytest.approx(2.0)
  assert rows_t["z/img_per_sec"] == pytest.approx(16.0)
  assert rows_t["z/img_per_sec_per_core"] == pytest.approx(16.0)
  assert rows_t["z/epoch"] == pytest.approx(0.7)
  assert rows_t["z/core_hours_cpu"] == pytest.approx(8.0 / 3600)
  _same_but_for_the_cores(rows_t, rows_j)
  assert ct.note == cj.note and "ETA: 3m6s" in ct.note
  with pytest.raises(AssertionError, match="resume without pause"):
    ct.resume()


def test_chrono_keeps_pauses_across_a_tick_inside_a_pause(monkeypatch):
  """The evaluator cadence ticks inside its pause. The port keeps the time
  of the pauses before such a tick on the books (the JAX Chrono forgets
  it, and then counts a checkpoint's time as training time)."""
  clock, ct, _, rows_t, _ = _chrono_pair(monkeypatch)
  ct.tick(1)
  ct.tick(3)
  clock.now += 2.0
  ct.tick(4)                          # 1 step, 2 s
  assert rows_t["z/secs_per_step"] == pytest.approx(2.0)
  ct.pause()
  clock.now += 10.0                   # checkpoint
  ct.resume()
  ct.pause()
  ct.tick(4)                          # the evaluator's tick: nothing to report
  clock.now += 20.0                   # evaluation
  ct.resume()
  clock.now += 3.0
  ct.tick(5)                          # 1 step, 3 s of training
  assert rows_t["z/secs_per_step"] == pytest.approx(3.0)


def test_chrono_save_load_matches_jax(monkeypatch):
  clock, ct, cj, _, _ = _chrono_pair(monkeypatch)
  for c in (ct, cj):
    c.tick(1)
    c.tick(3)
  clock.now += 6.0
  ct.tick(5)
  cj.tick(5)
  np.testing.assert_array_equal(ct.save(), cj.save())
  assert ct.save().dtype == np.float64 and ct.save()[0] == 6.0
  fresh = chrono.Chrono(device="cpu", clock=clock)
  fresh.load(torch.from_numpy(cj.save()))
  assert fresh.accum_train_time == 6.0


def _logits(seed, shape):
  return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("reduction", [True, False])
def test_sigmoid_and_softmax_xent_match_jax(reduction):
  logits = _logits(0, (6, 10)) * 3
  labels = (np.random.default_rng(1).random((6, 10)) < 0.3).astype(np.float32)
  soft = np.random.default_rng(2).dirichlet(np.ones(10), 6).astype(np.float32)
  t = torch.from_numpy
  # f32 log-sigmoid / log-softmax sums of 10 terms on both sides.
  tol = dict(rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(
      losses.sigmoid_xent(logits=t(logits), labels=t(labels),
                          reduction=reduction).numpy(),
      jlosses.sigmoid_xent(logits=logits, labels=labels, reduction=reduction),
      **tol)
  for kl in (False, True):
    np.testing.assert_allclose(
        losses.softmax_xent(logits=t(logits), labels=t(soft),
                            reduction=reduction, kl=kl).numpy(),
        jlosses.softmax_xent(logits=logits, labels=soft, reduction=reduction,
                             kl=kl), **tol)


@pytest.mark.parametrize("weighted,smoothing,normalize", [
    (False, 0.0, True), (True, 0.1, True), (True, 0.0, False)])
def test_weighted_softmax_xent_matches_jax(weighted, smoothing, normalize):
  logits = _logits(3, (4, 5, 7))
  labels = np.random.default_rng(4).integers(0, 7, (4, 5))
  weights = ((np.random.default_rng(5).random((4, 5)) < 0.7)
             .astype(np.float32) if weighted else None)
  got = losses.weighted_softmax_xent(
      logits=torch.from_numpy(logits), labels=torch.from_numpy(labels),
      weights=None if weights is None else torch.from_numpy(weights),
      label_smoothing=smoothing, normalize=normalize, reduction=False)
  want = jlosses.weighted_softmax_xent(
      logits=logits, labels=jnp.asarray(labels),
      weights=None if weights is None else jnp.asarray(weights),
      label_smoothing=smoothing, normalize=normalize, reduction=False)
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_bidirectional_contrastive_loss_matches_jax(masked):
  zimg, ztxt = _logits(6, (5, 8)), _logits(7, (5, 8))
  mask = np.array([1, 1, 0, 1, 1], np.float32) if masked else None
  tm = None if mask is None else torch.from_numpy(mask)
  jm = None if mask is None else jnp.asarray(mask)
  got, extra = losses.bidirectional_contrastive_loss(
      torch.from_numpy(zimg), torch.from_numpy(ztxt), t=2.0, mask=tm)
  want, jextra = jlosses.bidirectional_contrastive_loss(zimg, ztxt, t=2.0,
                                                        mask=jm)
  tol = dict(rtol=1e-5, atol=1e-5)  # f32 products over 8 terms
  np.testing.assert_allclose(got.numpy(), want, **tol)
  np.testing.assert_allclose(extra["logits"].numpy(), jextra["logits"], **tol)
  got, extra = losses.bidirectional_contrastive_loss(
      torch.from_numpy(zimg), torch.from_numpy(ztxt), mask=tm, reduction=True)
  want, jextra = jlosses.bidirectional_contrastive_loss(zimg, ztxt, mask=jm,
                                                        reduction=True)
  np.testing.assert_allclose(float(got), float(want), **tol)
  assert float(extra["ncorrect"]) == float(jextra["ncorrect"])


def _write_rows(writer_cls, workdir, tensor):
  config = {"seed": 0, "model": {"width": 64}, "betas": (0.9, 0.95)}
  mw = writer_cls(str(workdir), config)
  mw.measure("num_params", 123)       # step 0's metrics are dropped...
  mw.step_start(1)                    # ...when the next step starts
  mw.measure("training_loss", tensor(np.float32(0.5)))
  mw.measure("epochs", 1 / 16)
  mw.step_end()
  mw.step_start(2)
  mw.step_end()                       # an empty step writes no row
  mw.step_start(3)
  mw.measure("vector", tensor(np.arange(3, dtype=np.float32)))
  mw.measure("val/loss", np.float64(0.25))
  mw.close()                          # ends the open step
  rows = [json.loads(l) for l in open(workdir / "sv_tpu_metrics.txt")]
  return rows, json.load(open(workdir / "config.json"))


def test_metric_writer_rows_match_jax(tmp_path):
  (tmp_path / "t").mkdir()
  (tmp_path / "j").mkdir()
  rows_t, config_t = _write_rows(metrics.MetricWriter, tmp_path / "t",
                                 torch.as_tensor)
  rows_j, config_j = _write_rows(jmetrics.MetricWriter, tmp_path / "j",
                                 jnp.asarray)
  assert rows_t == rows_j
  assert [r["step"] for r in rows_t] == [1, 3]
  assert rows_t[1] == {"step": 3, "vector": [0.0, 1.0, 2.0], "val/loss": 0.25}
  assert config_t == config_j


def test_metric_writer_fetches_tensors_off_the_main_thread(tmp_path):
  seen = []

  class Sink:
    def log(self, row):
      import threading
      seen.append((threading.current_thread().name, row))

    def close(self):
      seen.append("closed")

  mw = metrics.MetricWriter(None, None, sinks=[Sink()])
  mw.step_start(5)
  held = mw.measure("loss", torch.tensor(1.5))
  assert isinstance(held, torch.Tensor)  # not fetched by the caller
  mw.close()
  (thread, row), closed = seen
  assert thread != "MainThread" and row == {"step": 5, "loss": 1.5}
  assert closed == "closed"


def test_make_sinks_refuses_wandb():
  assert metrics.make_sinks({"seed": 0}) == []
  with pytest.raises(ImportError, match="wandb"):
    metrics.MetricWriter(None, {"wandb": {"project": "x"}})
