"""A random-access source of .npy memmaps on disk.

Counterpart of small_vision_tpu/data/arrays.py. A memmap and a permutation
of its indices per (seed, epoch) give an exact global shuffle at no RAM
cost. Layout, a single-split directory or a parent of split directories:

  {root}/images.npy  (N, H, W, C) uint8 [+ labels.npy (N,) int]
  {root}/{split}/images.npy [+ labels.npy]   (multi-split parent)

With a parent root, `data=arrays:<root>` serves the train loop
(split="train") and the evaluators (split="validation"). Splits take the
TFDS subsplit syntax `name[lo:hi]`, with absolute, negative or percent
bounds (out-of-range bounds clamp). `write_arrays` writes one split
directory; tools/ingest_arrays.py decodes an image tree into one.
"""

import os
import re
from typing import Iterator, Optional

import numpy as np

from small_vision_tpu_torch.data import core

_SPLIT_RE = re.compile(r"^([\w-]+)(?:\[([^\[\]]*)\])?$")


def write_arrays(root: str, images: np.ndarray,
                 labels: Optional[np.ndarray] = None):
  os.makedirs(root, exist_ok=True)
  np.save(os.path.join(root, "images.npy"), images)
  if labels is not None:
    np.save(os.path.join(root, "labels.npy"), labels)


def parse_split(split: str):
  """'train[:100000]' -> ('train', f(n) -> (lo, hi)).

  Bounds are example counts or percents ('train[:10%]'); an omitted bound
  is the end, a negative count counts from the end, and out-of-range
  bounds clamp.
  """
  m = _SPLIT_RE.match(split)
  if not m:
    raise ValueError(f"Malformed split spec {split!r} "
                     "(expected e.g. 'train', 'validation[:1000]', "
                     "'train[50%:]').")
  base, sl = m.group(1), m.group(2)
  if sl is not None and sl.count(":") != 1:
    raise ValueError(f"Split slice must be 'lo:hi' in {split!r}")

  def one(bound, n, default):
    bound = bound.strip()
    if not bound:
      return default
    if bound.endswith("%"):
      pct = float(bound[:-1])
      if not 0 <= pct <= 100:
        raise ValueError(f"Percent bound out of [0, 100] in {split!r}")
      return int(n * pct / 100)
    i = int(bound)
    return max(0, min(n, i + n if i < 0 else i))

  def bounds(n):
    if sl is None:
      return 0, n
    lo_spec, hi_spec = sl.split(":")
    lo, hi = one(lo_spec, n, 0), one(hi_spec, n, n)
    return lo, max(lo, hi)

  return base, bounds


class DataSource(core.DataSource):

  def __init__(self, *, root: str, split: str = "train", split_frac=None):
    base, bounds = parse_split(split)
    sub = os.path.join(root, base)
    if os.path.exists(os.path.join(sub, "images.npy")):
      root = sub  # Multi-split parent: {root}/{split}/images.npy.
    elif not os.path.exists(os.path.join(root, "images.npy")):
      raise FileNotFoundError(
          f"No arrays data at {root!r}: expected images.npy there (single "
          f"split) or under {sub!r} (multi-split parent). Build one with "
          f"data.arrays.write_arrays or `{core.INGEST_TOOL}`.")
    elif split_frac is None and base not in (
        "train", os.path.basename(os.path.normpath(root))):
      # A single-split directory serves only its own split (or the default
      # "train", or an explicit split_frac slice under any name): returning
      # the same data under another split name would leak train into eval.
      raise ValueError(
          f"arrays source at {root!r} holds a single split; got "
          f"split={split!r}. Point the config at a multi-split parent dir "
          f"(with a {base}/ subdir) or at the per-split dir itself.")
    self.root = root
    self.images = np.load(os.path.join(root, "images.npy"), mmap_mode="r")
    labels_path = os.path.join(root, "labels.npy")
    self.labels = (np.load(labels_path, mmap_mode="r")
                   if os.path.exists(labels_path) else None)
    n = self.images.shape[0]
    if split_frac is not None:
      lo, hi = int(n * split_frac[0]), int(n * split_frac[1])
    else:
      lo, hi = bounds(n)
    self._lo, self._hi = lo, hi
    self._num_classes = None

  @property
  def total_examples(self) -> int:
    return self._hi - self._lo

  @property
  def num_classes(self):
    """max label + 1, or None without labels."""
    if self.labels is None:
      return None
    if self._num_classes is None:
      self._num_classes = int(np.max(self.labels)) + 1
    return self._num_classes

  def _example(self, i):
    ex = {"image": np.asarray(self.images[i]), "_id": np.int64(i)}
    if self.labels is not None:
      ex["label"] = np.int64(self.labels[i])
    return ex

  @property
  def num_local_examples(self) -> int:
    start, stop = core.even_split_range(self.total_examples)
    return stop - start

  def _epoch_index(self, ordered, seed, epoch):
    start, stop = core.even_split_range(self.total_examples)
    idx = np.arange(self._lo + start, self._lo + stop)
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
    return self._example(self._lo)
