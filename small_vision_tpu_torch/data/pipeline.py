"""The input pipeline: host pp workers, then batches of tensors on the
device, then the device pp.

Counterpart of small_vision_tpu/data/pipeline.py (`training`, `TrainIterator`
with `start_step` resume, `MixedSource`, `make_for_inference` with its
zero padding and `_mask`). Each process reads its shard of the source
(`data.core.process_shard()`) and batches of the global batch size over
the shard count, on its own device:

  - a producer thread walks the source's examples, gives each its
    augmentation rng `default_rng((seed, epoch, _id))` and maps the host
    stage of the pp string over chunks of `batch_size * num_workers`
    examples: first through the host stage's whole-chunk path (`batch`,
    the native JPEG decoder's own threads) where it has one, else through
    a pool of `num_workers` threads. A worker's exception reaches the
    consumer. The thread does no CUDA work;
  - the consumer collates each batch into pinned host tensors and copies
    them to the device with `non_blocking=True` on the current stream,
    `prefetch` batches ahead of the one it yields; the step that reads a
    batch runs on the same stream, after its copy;
  - the device stage (`DevicePP`) is the iterator's, and the caller applies
    it to each batch with its own draws.

The bits of every batch (`_id`, image and label bytes) are those of the JAX
`TrainIterator` on the same source and pp string.
"""

import concurrent.futures
import itertools
import logging
import queue
import threading
from collections import deque
from typing import Iterator

import numpy as np
import torch

from small_vision_tpu_torch.data import core as ds_core
from small_vision_tpu_torch.pp import builder as pp_builder
import small_vision_tpu_torch.pp.autoaugment  # noqa: F401 (registers randaug)

_POLL_S = 0.1  # how often a blocked producer looks at its stop flag


def _collate(examples):
  """Stacks a list of example dicts into one numpy batch dict."""
  keys = [k for k in examples[0] if not k.startswith("_rng")]
  return {k: np.stack([np.asarray(e[k]) for e in examples]) for k in keys}


def _put(q: queue.Queue, item, stop: threading.Event) -> bool:
  """Puts `item` unless `stop` is set first; True where it went in."""
  while not stop.is_set():
    try:
      q.put(item, timeout=_POLL_S)
      return True
    except queue.Full:
      pass
  return False


class _HostPipeline:
  """The host stage over an example stream, on a producer thread, yielding
  numpy batches of `local_batch_size`."""

  def __init__(self, example_iter_factory, host_pp, local_batch_size,
               num_workers=8, depth=4, drop_remainder=True, seed=0,
               index_start=0):
    self.factory = example_iter_factory
    self.host_pp = host_pp
    self.bs = local_batch_size
    self.num_workers = max(1, num_workers)
    self.depth = depth
    self.drop_remainder = drop_remainder
    self.seed = seed
    self.index_start = index_start  # stream position on resume

  def __iter__(self):
    out_q = queue.Queue(maxsize=self.depth)
    stop = threading.Event()

    def producer():
      try:
        pool = (concurrent.futures.ThreadPoolExecutor(self.num_workers)
                if self.num_workers > 1 else None)
        try:
          buf = []
          for i, ex in enumerate(self.factory(), start=self.index_start):
            if stop.is_set():
              return
            ex = dict(ex)
            # The example's augmentation rng, keyed (seed, epoch, id): fresh
            # draws every epoch, and the same draws for a given visit
            # whatever the worker count or batch size (the stream position
            # stands in for a missing id, and `index_start` keeps it
            # continuous across a resume).
            ex["_rng"] = np.random.default_rng(
                (self.seed, int(ex.pop("_epoch", 0)), int(ex.get("_id", i))))
            buf.append(ex)
            if len(buf) == self.bs * self.num_workers:
              if not self._flush(buf, out_q, stop, pool):
                return
              buf = []
          if buf and not self._flush(buf, out_q, stop, pool, final=True):
            return
          _put(out_q, None, stop)
        finally:
          if pool is not None:
            pool.shutdown(wait=True)
      except BaseException as e:  # noqa: BLE001 - handed to the consumer
        _put(out_q, e, stop)

    thread = threading.Thread(target=producer, daemon=True,
                              name="host-input-pipeline")
    thread.start()
    try:
      while True:
        item = out_q.get()
        if item is None:
          break
        if isinstance(item, BaseException):
          raise RuntimeError("host input pipeline worker failed") from item
        yield item
    finally:
      stop.set()
      thread.join()

  def _flush(self, buf, out_q, stop, pool, final=False) -> bool:
    """Maps the host stage over the chunk and queues its whole batches (and
    a short last one where `final` and not `drop_remainder`); False where
    the consumer stopped."""
    batch_fn = getattr(self.host_pp, "batch", None)
    done = batch_fn([dict(e) for e in buf]) if batch_fn is not None else None
    if done is not None:
      buf = done
    elif pool is not None and len(buf) > 1:
      buf = list(pool.map(self.host_pp, buf))
    else:
      buf = [self.host_pp(e) for e in buf]
    for i in range(0, len(buf), self.bs):
      chunk = buf[i:i + self.bs]
      if len(chunk) < self.bs and (self.drop_remainder or not final):
        continue
      if not _put(out_q, _collate(chunk), stop):
        return False
    return True


def to_device(batch: dict, device) -> dict:
  """The batch's numeric arrays as tensors on `device`: on a CUDA device
  through pinned host memory, copied with `non_blocking=True` on the
  current stream (PyTorch's pinned-memory cache keeps each pinned block
  until its copy has finished); other arrays (strings) stay numpy."""
  device = torch.device(device)
  out = {}
  for k, v in batch.items():
    if v.dtype.kind not in "biuf":
      out[k] = v
      continue
    t = torch.from_numpy(np.ascontiguousarray(v))
    if device.type == "cuda":
      pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
      pinned.copy_(t)
      t = pinned.to(device, non_blocking=True)
    else:
      t = t.to(device)
    out[k] = t
  return out


class TrainIterator:
  """Endless training batches on `device`: dicts of tensors, uint8 images
  as the host stage leaves them, for the device stage `device_pp`.

  `start_step`, set before iterating, continues the stream where a run of
  that many steps left it (a source that knows its per-epoch count, such
  as arrays and synthetic, resumes exactly; others restart at epoch 0 and
  warn).
  """

  def __init__(self, source: ds_core.DataSource, pp_spec: str,
               batch_size: int, *, device="cuda", seed: int = 0,
               num_workers: int = 8, prefetch: int = 2, host_pp=None,
               device_pp=None):
    self.source = source
    self.batch_size = batch_size
    self.device = torch.device(device)
    if host_pp is not None:  # pre-built (dataset mixing dispatches per source)
      self.host_pp, self.device_pp = host_pp, device_pp
    else:
      self.host_pp, self.device_pp = pp_builder.get_preprocess_fn(pp_spec)
    self.seed = seed
    self.num_workers = num_workers
    self.prefetch = prefetch
    self.start_step = 0

  def _epochs(self):
    consumed = self.start_step * self.batch_size
    epoch0, skip = 0, 0
    if consumed:
      n_local = self.source.num_local_examples
      if n_local:
        epoch0, skip = divmod(consumed, n_local)
      else:
        logging.warning(
            "Resuming at step %d but %s does not know its per-epoch length; "
            "data order restarts at epoch 0 (non-deterministic resume).",
            self.start_step, type(self.source).__name__)
    for epoch in itertools.count(epoch0):
      it = (self.source.examples_from(seed=self.seed, epoch=epoch, start=skip)
            if skip else self.source.examples(seed=self.seed, epoch=epoch))
      skip = 0
      for ex in it:
        ex = dict(ex)
        ex.setdefault("_epoch", epoch)  # MixedSource tags its own epochs
        yield ex

  def __iter__(self) -> Iterator[dict]:
    host = iter(_HostPipeline(
        self._epochs, self.host_pp, self.batch_size,
        num_workers=self.num_workers, seed=self.seed,
        index_start=self.start_step * self.batch_size))
    buf = deque()
    try:
      for batch in host:
        buf.append(to_device(batch, self.device))
        if len(buf) > self.prefetch:
          yield buf.popleft()
      while buf:
        yield buf.popleft()
    finally:
      host.close()  # stops the producer thread


class MixedSource(ds_core.DataSource):
  """A weighted example-level mixture of several sources, for training.

  Each source cycles its own epochs; a seeded categorical picks the source
  of each example, in blocks of 1,024, and `_mix` tags the example with
  it so that the host stage runs that source's pipeline.
  """

  def __init__(self, sources, weights):
    w = np.asarray(weights, np.float64)
    if not ((w > 0).all() and len(w) == len(sources)):
      raise ValueError(f"one positive weight per source, got {weights}")
    self.sources = list(sources)
    self.weights = w / w.sum()

  @property
  def total_examples(self) -> int:
    return sum(s.total_examples for s in self.sources)

  def examples(self, *, ordered: bool = False, seed: int = 0,
               epoch: int = 0):
    if ordered:
      raise ValueError("MixedSource is a training-only (shuffled) source")

    def cycle(src):
      for ep in itertools.count(epoch):
        for ex in src.examples(seed=seed, epoch=ep):
          ex = dict(ex)
          ex["_epoch"] = ep  # fresh augmentation draws every epoch
          yield ex
    iters = [cycle(s) for s in self.sources]
    rng = np.random.default_rng((seed, epoch, ds_core.process_shard()[0]))
    while True:
      for i in rng.choice(len(iters), size=1024, p=self.weights):
        ex = dict(next(iters[i]))
        ex["_mix"] = np.int32(i)
        yield ex


def _mix_host_pp(host_pps):
  def pp(ex):
    ex = dict(ex)
    return host_pps[int(ex.pop("_mix"))](ex)
  return pp


_TRAINING_KEYS = frozenset(
    {"data", "pp", "batch_size", "seed", "num_workers", "prefetch_to_device"})


def training(cfg, device="cuda"):
  """(TrainIterator, its DevicePP, the number of training examples) from a
  config's `input` dict. The iterator yields this process's batches: the
  config's (global) batch size over the process shard count.

  One dataset: `cfg["data"]` has a `name`. A mixture: `cfg["data"]` maps
  {dataset key: weight} and each `cfg[dataset key]` has its own `data` and
  `pp`, whose device stages must be the same (the mixture has one).
  """
  cfg = dict(cfg)
  data_cfg = dict(cfg["data"])
  mixing = not isinstance(data_cfg.get("name"), str)
  allowed = _TRAINING_KEYS | (set(data_cfg) if mixing else set())
  unknown = set(cfg) - allowed
  if unknown:
    raise ValueError(
        f"Unknown input-config keys {sorted(unknown)}; "
        f"known keys: {sorted(allowed)}")
  kw = dict(device=device, seed=cfg.get("seed", 0),
            num_workers=cfg.get("num_workers", 8),
            prefetch=cfg.get("prefetch_to_device", 2))
  local_bs = _local_batch(cfg["batch_size"])

  if not mixing:
    source = ds_core.get(data_cfg.pop("name"), **data_cfg)
    it = TrainIterator(source, cfg.get("pp", ""), local_bs, **kw)
    return it, it.device_pp, source.total_examples

  names = list(data_cfg)
  sources, host_pps, device_specs = [], [], []
  for n in names:
    sub = dict(cfg[n])
    d = dict(sub["data"])
    sources.append(ds_core.get(d.pop("name"), **d))
    host_spec, device_spec = pp_builder.split_stages(sub.get("pp", ""))
    host_pps.append(pp_builder.get_preprocess_fn(host_spec)[0])
    device_specs.append(device_spec)
  if len(set(device_specs)) > 1:
    raise ValueError(
        "Mixed datasets must share an identical device pp stage (the "
        f"mixture has one); got {dict(zip(names, device_specs))}")
  mixed = MixedSource(sources, [float(data_cfg[n]) for n in names])
  it = TrainIterator(mixed, "", local_bs,
                     host_pp=_mix_host_pp(host_pps),
                     device_pp=pp_builder.DevicePP(device_specs[0]), **kw)
  return it, it.device_pp, mixed.total_examples


def _local_batch(batch_size: int) -> int:
  count = ds_core.process_shard()[1]
  if batch_size % count:
    raise ValueError(f"batch size {batch_size} does not divide over {count} "
                     "processes")
  return batch_size // count


def make_for_inference(source: ds_core.DataSource, pp_spec: str,
                       batch_size: int, *, num_workers: int = 8):
  """(iterate, device_pp, n_steps) over this process's ordered examples.

  `iterate()` yields `n_steps` numpy batches of `batch_size` over the
  process shard count rows through the host stage, the last one
  zero-padded and every one with `_mask` (1.0 on real rows, 0.0 on
  padding); `device_pp` is the string's device stage, which the caller
  applies on the device. Every process runs the same `n_steps`, that of
  the largest shard, padding with all-zero batches built from
  `source.peek()`: a process whose shard is shorter, or empty, still takes
  part in every collective of the evaluation (the deadlock JAX's
  `make_for_inference` guards against).
  """
  host_pp, device_pp = pp_builder.get_preprocess_fn(pp_spec)
  batch_size = _local_batch(batch_size)
  n_steps = -(-max(source.num_examples_per_process, 1) // batch_size)

  def padding():
    ex = dict(source.peek())
    ex["_rng"] = np.random.default_rng(0)
    one = _collate([host_pp(ex)])
    tmpl = {k: np.zeros((batch_size,) + v.shape[1:], v.dtype)
            for k, v in one.items()}
    tmpl["_mask"] = np.zeros((batch_size,), np.float32)
    return tmpl

  def iterate():
    template = padding()
    host = iter(_HostPipeline(
        lambda: source.examples(ordered=True), host_pp, batch_size,
        num_workers=num_workers, drop_remainder=False))
    emitted = 0
    try:
      for batch in host:
        if emitted >= n_steps:
          break
        b = next(iter(batch.values())).shape[0]
        mask = np.ones((b,), np.float32)
        if b < batch_size:
          pad = batch_size - b
          batch = {k: np.concatenate(
              [v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                   for k, v in batch.items()}
          mask = np.concatenate([mask, np.zeros((pad,), np.float32)])
        batch["_mask"] = mask
        emitted += 1
        yield batch
    finally:
      host.close()
    while emitted < n_steps:
      emitted += 1
      yield dict(template)

  return iterate, device_pp, n_steps
