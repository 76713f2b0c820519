"""Sample-collection evaluator for FID/IS.

Counterpart of small_vision_tpu/evaluators/diffusion_sampling.py: calls the
trainer's sample function (with a generator seeded 0 at every run, so that
curves are comparable across steps) until `total_samples` are collected, and
yields `("fid_samples", {"samples": …, "ys": …})` plus an example grid.
Over several processes each data shard p (`data.core.process_shard()`)
samples its share, ceil(total / count), with a generator seeded p, and the
shares are gathered in shard order (`parallel.collectives.fetch_global`);
one process draws what the single-process evaluator draws.
"""

import numpy as np
import torch

from small_vision_tpu_torch.evaluators import common
from small_vision_tpu_torch.data import core as ds_core


class Evaluator:
  """predict_fn = a trainer sample fn: (train_state, generator) -> dict with
  fid_samples/image_examples/ys."""

  def __init__(self, predict_fn, *, device, batch_size, total_samples=10_000):
    del batch_size  # the call size is the config's num_samples_per_call
    self.total_samples = int(total_samples)
    self.device = torch.device(device)
    self._sample_fn = predict_fn

  def run(self, train_state):
    rank, count = ds_core.process_shard()
    gen = torch.Generator(device=self.device).manual_seed(rank)
    samples, labels = [], []
    n = 0
    example_grid = None
    while n < -(-self.total_samples // count):
      out = self._sample_fn(train_state, gen)
      samples.append(out["fid_samples"].cpu().numpy())
      if out["ys"] is not None:
        labels.append(out["ys"].cpu().numpy())
      if example_grid is None:
        example_grid = out["image_examples"].cpu().numpy()
      n += samples[-1].shape[0]

    samples = np.concatenate(samples)
    ys = np.concatenate(labels) if labels else None
    if count > 1:
      samples, ys = common.gather_rows(self, [samples, ys])
    samples = samples[:self.total_samples]
    ys = ys[:self.total_samples] if ys is not None else None
    yield "fid_samples", {"samples": samples, "ys": ys}
    yield "image_examples", example_grid
