"""The data-source API and the source registry.

Counterpart of small_vision_tpu/data/core.py: a `DataSource` base class of
restartable sources of numpy example dicts, and `get(name)`. Shuffling is
an index permutation per (seed, epoch), so a random-access source shuffles
globally without a shuffle buffer. Each process reads its own shard,
`even_split_range` of the examples by `process_shard()`: by default the
process's rank and the world size (JAX's process index and count), and
under a mesh the trainer's `set_process_shard` (its position on the batch
axes: the processes of one pipeline read the same rows).

Sources: "synthetic", "arrays" (npy memmaps), "arrays:<root>",
"latents" (the JAX package's TFRecords of precomputed VAE latents, read
without TensorFlow; `pattern=` names the files), and "mod:<module>" (a
module with a `DataSource` class). TFDS sources need TensorFlow, which the
port does not use: their names raise and point at the arrays route.
"""

import abc
import importlib
import itertools
from typing import Iterator, Optional

INGEST_TOOL = "python -m small_vision_tpu_torch.tools.ingest_arrays"


_SHARD = None  # (index, count) set by `set_process_shard`


def set_process_shard(index=None, count=None):
  """Makes (index, count) the shard of the data this process reads; None
  goes back to (rank, world size)."""
  global _SHARD
  _SHARD = None if index is None else (int(index), int(count))


def process_shard() -> tuple:
  """(index, count) of this process's shard of every source."""
  if _SHARD is not None:
    return _SHARD
  from small_vision_tpu_torch.parallel import mesh as mesh_lib
  return mesh_lib.process_index(), mesh_lib.process_count()


def even_split_range(total: int, index=None, count=None):
  """[start, stop) of process `index`'s shard of `total` examples over
  `count` processes (default: `process_shard()`), the first `total % count`
  taking one more (the semantics of tfds.even_splits)."""
  if index is None or count is None:
    index, count = process_shard()
  base, rem = divmod(total, count)
  start = index * base + min(index, rem)
  return start, start + base + (1 if index < rem else 0)


class DataSource(abc.ABC):
  """A restartable source of example dicts."""

  @abc.abstractmethod
  def examples(self, *, ordered: bool = False, seed: int = 0,
               epoch: int = 0) -> Iterator[dict]:
    """Yields the examples, shuffled per (seed, epoch) unless ordered."""

  @property
  @abc.abstractmethod
  def total_examples(self) -> int:
    """The number of examples."""

  @property
  def num_examples_per_process(self) -> int:
    """The most examples a process holds, the same on every process:
    ceil(total / count). The evaluators' step count comes from it."""
    return -(-self.total_examples // process_shard()[1])

  @property
  def num_local_examples(self) -> Optional[int]:
    """This process's exact count per epoch, or None where unknown.

    A random-access source knows it, and `TrainIterator.start_step` then
    resumes mid-epoch where a run left off; with None a resume restarts
    the data order at epoch 0.
    """
    return None

  def examples_from(self, *, seed: int, epoch: int,
                    start: int) -> Iterator[dict]:
    """Epoch `epoch`'s examples from position `start`. The default skips by
    consuming; random-access sources slice their index instead."""
    return itertools.islice(
        self.examples(seed=seed, epoch=epoch), start, None)

  def peek(self) -> dict:
    """One raw example of the dataset, on every process (one whose shard is
    empty too): the template of the evaluators' padding batches. Default:
    the first ordered example of this process's shard."""
    for ex in self.examples(ordered=True):
      return ex
    raise ValueError(f"{type(self).__name__} has no examples to peek at")


_KNOWN = {"synthetic": "small_vision_tpu_torch.data.synthetic",
          "arrays": "small_vision_tpu_torch.data.arrays",
          "latents": "small_vision_tpu_torch.data.latents"}


def get(name: str, **kw) -> DataSource:
  """The source `name`, built with `kw` (e.g. `split="validation"`)."""
  if name.startswith("mod:"):
    return importlib.import_module(name[4:]).DataSource(**kw)
  if name.startswith("arrays:"):
    return get("arrays", root=name[len("arrays:"):], **kw)
  if name not in _KNOWN:
    what = ("the TFDS source" if name == "tfds"
            else f"dataset {name!r} (a TFDS name)")
    raise ValueError(
        f"data source {name!r}: {what} needs TensorFlow, which the port "
        f"does not use. Decode the images once into an arrays dataset with "
        f"`{INGEST_TOOL} --src dir:<class tree> --out <root>/train` (and "
        f"<root>/validation) and train on data=arrays:<root>.")
  return importlib.import_module(_KNOWN[name]).DataSource(**kw)
