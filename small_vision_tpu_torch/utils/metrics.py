"""Metric writer: JSON lines, written off the main thread.

Counterpart of small_vision_tpu/utils/metrics.py: appends one JSON row per
step to `{workdir}/sv_tpu_metrics.txt` through a single worker thread (so
that neither the device-to-host copy of a value nor the disk ever blocks the
train loop), dumps the config once as `config.json`, and fans each finished
row out to any sinks. A sink is any object with `log(row: dict)` and
`close()`.
"""

import json
import os
import queue
import threading

import numpy as np
import torch


def make_sinks(config):
  """Sinks from the config. The port has no Weights & Biases sink: a config
  that sets `wandb` raises here, because dropping a run's metrics without a
  word is worse."""
  if hasattr(config, "get") and config.get("wandb"):
    raise ImportError(
        "config['wandb'] is set but the port has no wandb sink; remove the "
        "entry or pass MetricWriter(sinks=[...]) a sink of your own")
  return []


def _plain(value):
  """A float for one element, a nested list for more."""
  if isinstance(value, torch.Tensor):
    value = value.detach().cpu().numpy()
  value = np.asarray(value)
  if value.size == 1:
    return float(value.reshape(-1)[0])
  return value.tolist()


class MetricWriter:

  def __init__(self, workdir=None, config=None, sinks=None):
    self.step_start(0)
    self._sinks = list(sinks) if sinks is not None else make_sinks(config)
    self.fname = None
    if workdir:
      os.makedirs(workdir, exist_ok=True)
      self.fname = os.path.join(workdir, "sv_tpu_metrics.txt")
      if config is not None:
        with open(os.path.join(workdir, "config.json"), "w") as f:
          f.write(json.dumps(config, default=str))

    self._q = queue.Queue()
    self._worker = threading.Thread(target=self._run, daemon=True)
    self._worker.start()

  def _run(self):
    while True:
      item = self._q.get()
      if item is None:
        return
      row, fname = item
      # Values may still be tensors on the device; fetch here, off the main
      # thread.
      row = {k: v if isinstance(v, (int, float, list)) else _plain(v)
             for k, v in row.items()}
      if fname:
        with open(fname, "a") as f:
          f.write(json.dumps(row) + "\n")
      for sink in self._sinks:
        sink.log(row)

  def step_start(self, step):
    self.step = step
    self.step_metrics = {}

  def measure(self, name, value):
    """Records one metric for the current step. A tensor is kept as it is
    (detached) and fetched by the worker thread; anything else is made plain
    at once and returned."""
    if isinstance(value, torch.Tensor):
      value = value.detach()
    else:
      value = _plain(value)
    self.step_metrics[name] = value
    return value

  def step_end(self):
    if not self.step_metrics:
      return
    row = {"step": self.step, **self.step_metrics}
    self._q.put((row, self.fname))
    self.step_metrics = {}

  def close(self):
    self.step_end()
    self._q.put(None)
    self._worker.join(timeout=10)
    for sink in self._sinks:
      sink.close()
