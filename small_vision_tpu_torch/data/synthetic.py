"""Synthetic image source for tests, smoke runs and throughput runs.

Counterpart of small_vision_tpu/data/synthetic.py: a fixed pool of
pseudo-random uint8 images drawn from `np.random.default_rng(seed)` (seed +
1 for other splits), labels `i % num_classes` by example index, and a
per-epoch shuffle from `np.random.default_rng((seed, epoch))`. A host
stage costs one dict per example, so the device step dominates a run.
"""

from typing import Iterator

import numpy as np

from small_vision_tpu_torch.data import core


class DataSource(core.DataSource):

  def __init__(self, *, split: str = "train", img_size: int = 64,
               channels: int = 3, num_classes: int = 1000,
               num_examples: int = 50_000, pool: int = 2048, seed: int = 17):
    self.img_size = img_size
    self.channels = channels
    self.num_classes = num_classes
    self._total = num_examples
    rng = np.random.default_rng(seed + (0 if split == "train" else 1))
    pool = min(pool, num_examples)
    self._images = rng.integers(
        0, 256, (pool, img_size, img_size, channels), dtype=np.uint8)
    self._pool = pool

  @property
  def total_examples(self) -> int:
    return self._total

  def _example(self, i):
    return {"image": self._images[i % self._pool],
            "label": np.int64(i % self.num_classes), "_id": np.int64(i)}

  @property
  def num_local_examples(self) -> int:
    start, stop = core.even_split_range(self.total_examples)
    return stop - start

  def _epoch_index(self, ordered, seed, epoch):
    start, stop = core.even_split_range(self.total_examples)
    idx = np.arange(start, stop)
    if not ordered:
      np.random.default_rng((seed, epoch)).shuffle(idx)
    return idx

  def examples(self, *, ordered: bool = False, seed: int = 0,
               epoch: int = 0) -> Iterator[dict]:
    for i in self._epoch_index(ordered, seed, epoch):
      yield self._example(i)

  def examples_from(self, *, seed: int, epoch: int,
                    start: int) -> Iterator[dict]:
    for i in self._epoch_index(False, seed, epoch)[start:]:
      yield self._example(i)

  def peek(self) -> dict:
    return self._example(0)
