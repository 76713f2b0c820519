"""Sample-collection evaluator for FID/IS.

Counterpart of small_vision_tpu/evaluators/diffusion_sampling.py: calls the
trainer's sample function (with a generator seeded 0 at every run, so that
curves are comparable across steps) until `total_samples` are collected, and
yields `("fid_samples", {"samples": …, "ys": …})` plus an example grid.
"""

import numpy as np
import torch


class Evaluator:
  """predict_fn = a trainer sample fn: (train_state, generator) -> dict with
  fid_samples/image_examples/ys."""

  def __init__(self, predict_fn, *, device, batch_size, total_samples=10_000):
    del batch_size  # the call size is the config's num_samples_per_call
    self.total_samples = int(total_samples)
    self.device = torch.device(device)
    self._sample_fn = predict_fn

  def run(self, train_state):
    gen = torch.Generator(device=self.device).manual_seed(0)
    samples, labels = [], []
    n = 0
    example_grid = None
    while n < self.total_samples:
      out = self._sample_fn(train_state, gen)
      samples.append(out["fid_samples"].cpu().numpy())
      if out["ys"] is not None:
        labels.append(out["ys"].cpu().numpy())
      if example_grid is None:
        example_grid = out["image_examples"].cpu().numpy()
      n += samples[-1].shape[0]

    samples = np.concatenate(samples)[:self.total_samples]
    ys = np.concatenate(labels)[:self.total_samples] if labels else None
    yield "fid_samples", {"samples": samples, "ys": ys}
    yield "image_examples", example_grid
