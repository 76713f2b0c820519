"""Synthetic image source for tests, smoke runs and throughput runs.

Counterpart of small_vision_tpu/data/synthetic.py: a fixed pool of
pseudo-random uint8 images drawn from `np.random.default_rng(seed)` (seed +
1 for other splits), labels `i % num_classes` by example index, and a
per-epoch shuffle from `np.random.default_rng((seed, epoch))`. The port
runs in one process, so the process's shard is every example.

`batches` is the plain batch iterator of the train loop: uint8 images and
int64 labels as numpy arrays, epochs back to back, gathered in bulk; with
`start_step` it continues the stream where a run of that many steps left
off.
"""

from typing import Iterator

import numpy as np


class DataSource:

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

  @property
  def num_examples_per_process(self) -> int:
    """The one process's share: every example."""
    return self._total

  def peek(self) -> dict:
    """Example 0, raw: the template of an evaluation batch's padding."""
    return next(self.examples(ordered=True))

  def epoch_index(self, ordered: bool = False, seed: int = 0,
                  epoch: int = 0) -> np.ndarray:
    """Example indices of one epoch, shuffled unless `ordered`."""
    idx = np.arange(self._total)
    if not ordered:
      np.random.default_rng((seed, epoch)).shuffle(idx)
    return idx

  def take(self, idx) -> dict:
    """The examples at indices `idx`, stacked."""
    idx = np.asarray(idx)
    return {"image": self._images[idx % self._pool],
            "label": (idx % self.num_classes).astype(np.int64)}

  def examples(self, *, ordered: bool = False, seed: int = 0,
               epoch: int = 0) -> Iterator[dict]:
    for i in self.epoch_index(ordered, seed, epoch):
      yield {"image": self._images[i % self._pool],
             "label": np.int64(i % self.num_classes), "_id": np.int64(i)}


def batches(source: DataSource, batch_size: int, *, seed: int = 0,
            start_step: int = 0) -> Iterator[dict]:
  """Endless {"image": (B, H, W, C) uint8, "label": (B,) int64} batches:
  the shuffled epochs back to back, a batch may span two epochs. The first
  batch is the one that step `start_step + 1` of a run from scratch takes."""
  epoch, skip = divmod(start_step * batch_size, source.total_examples)
  pending = source.epoch_index(seed=seed, epoch=epoch)[skip:]
  epoch += 1
  while True:
    while pending.size < batch_size:
      pending = np.concatenate(
          [pending, source.epoch_index(seed=seed, epoch=epoch)])
      epoch += 1
    yield source.take(pending[:batch_size])
    pending = pending[batch_size:]
