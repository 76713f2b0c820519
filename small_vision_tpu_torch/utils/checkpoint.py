"""Flat-npz weights, and resumable checkpoints of the whole train state.

Counterpart of small_vision_tpu/utils/checkpoint.py.

`save_params_npz` / `load_params_npz` are the zoo format (`export_sampler
--weights_out`, `model_init`): one `.npz` keyed by slash paths. numpy has no
bfloat16, so bf16 leaves are stored as uint16 bit-views under `{name}::bf16`
and decoded here into torch.bfloat16 tensors without any third-party dtype
package; the JAX package's loader reads these files and this one reads its.

The manager (`make_manager`, `save`, `restore`, `restore_subtree`,
`latest_step`, `wait_until_finished`) takes the place of the orbax manager
the JAX package delegates to. A checkpoint is a directory
`{workdir}/checkpoints/<step>/` with one flat npz per top-level entry of the
state (`params.npz`, `ema_params.npz`, `opt.npz`, `generator.npz`,
`chrono.npz`, ...), so it needs neither orbax nor pickle.
  - Asynchronous: `save` copies every tensor to host memory on the caller's
    CUDA stream (into pinned buffers that are kept between saves), so the
    copy is ordered before whatever the caller launches next, and returns; a
    thread waits for the copies, writes and renames. One save is in flight
    at a time: the next `save` first waits for the one before.
  - Atomic: written to `<step>.tmp`, renamed to `<step>` when complete. A
    directory that was never renamed is no checkpoint: it is ignored, and
    removed when the next manager starts on that workdir.
  - `keep_period`: steps that are a multiple of it stay for ever; of the
    others the newest `max_to_keep` stay.
"""

import os
import re
import shutil
import threading
import time
from typing import Mapping, Optional

import numpy as np
import torch

from small_vision_tpu_torch.utils.trees import (recover_tree,
                                                tree_flatten_with_names)

_BF16_SUFFIX = "::bf16"
_TMP_SUFFIX = ".tmp"
WRITER_THREAD = "checkpoint-writer"  # the name of a save's writer thread


def _flat_numpy(tree, cast_floating=None) -> dict:
  """{npz key: numpy array} of a nested (or flat) mapping of tensors, arrays
  and scalars, bf16 tensors as uint16 bit-views under `{name}::bf16`."""
  if isinstance(cast_floating, str):
    cast_floating = getattr(torch, cast_floating)
  out = {}
  for name, leaf in tree_flatten_with_names(tree):
    if not isinstance(leaf, torch.Tensor):
      out[name] = np.asarray(leaf)
      continue
    t = leaf.detach().cpu()
    if cast_floating is not None and t.is_floating_point():
      t = t.to(cast_floating)
    if t.dtype == torch.bfloat16:
      out[name + _BF16_SUFFIX] = t.contiguous().view(torch.int16).numpy().view(
          np.uint16)
    else:
      out[name] = t.numpy()
  return out


def save_params_npz(path: str, params: Mapping, cast_floating=None):
  """Writes a nested dict of tensors as a flat `a/b/c`-keyed .npz.

  `cast_floating`: optional torch dtype (or its name) applied to floating
  leaves before writing, e.g. torch.bfloat16 to halve a serving sidecar."""
  np.savez(path, **_flat_numpy(params, cast_floating))


def load_params_npz(path: str) -> dict:
  """Nested dict of torch tensors from a flat `a/b/c`-keyed .npz."""
  keys, values = [], []
  with np.load(path) as data:
    for k, v in data.items():
      if k.endswith(_BF16_SUFFIX):
        k = k[:-len(_BF16_SUFFIX)]
        t = torch.from_numpy(np.ascontiguousarray(v).view(np.int16)).view(
            torch.bfloat16)
      else:
        t = torch.from_numpy(np.ascontiguousarray(v))
      keys.append(k)
      values.append(t)
  return recover_tree(keys, values)


class Manager:
  """Checkpoints under `directory`, one sub-directory per step."""

  def __init__(self, directory: str, keep_period: Optional[int] = None,
               max_to_keep: int = 1):
    self.directory = directory
    self.keep_period = keep_period
    self.max_to_keep = max_to_keep
    self._thread = None
    self._error = None
    self._pinned = {}  # (entry, leaf name) -> pinned host tensor
    # Seconds of the last save: the caller's (host copies enqueued) and the
    # writer thread's (waiting for the copies, writing, renaming).
    self.last_blocking_s = None
    self.last_write_s = None
    os.makedirs(directory, exist_ok=True)
    for name in os.listdir(directory):
      if name.endswith(_TMP_SUFFIX):  # a save that never completed
        shutil.rmtree(os.path.join(directory, name), ignore_errors=True)

  def all_steps(self) -> list:
    return sorted(int(n) for n in os.listdir(self.directory)
                  if re.fullmatch(r"\d+", n))

  def latest_step(self) -> Optional[int]:
    steps = self.all_steps()
    return steps[-1] if steps else None

  def _host_copy(self, entry, tree):
    """The entry's leaves in host memory, detached from what the caller
    goes on to change."""
    out = {}
    for name, leaf in tree_flatten_with_names(tree):
      if not isinstance(leaf, torch.Tensor):
        out[name] = np.array(leaf)
      elif leaf.is_cuda:
        buf = self._pinned.get((entry, name))
        if buf is None or buf.shape != leaf.shape or buf.dtype != leaf.dtype:
          buf = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
          self._pinned[(entry, name)] = buf
        buf.copy_(leaf.detach(), non_blocking=True)
        out[name] = buf
      else:
        out[name] = leaf.detach().clone()
    return out

  def save(self, state: Mapping, step: int):
    self.wait_until_finished()
    t0 = time.perf_counter()
    host = {entry: self._host_copy(entry, tree)
            for entry, tree in state.items()}
    copied = None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
      copied = torch.cuda.Event()
      copied.record()
    self._thread = threading.Thread(target=self._write, name=WRITER_THREAD,
                                    args=(host, step, copied), daemon=True)
    self._thread.start()
    self.last_blocking_s = time.perf_counter() - t0

  def _write(self, host, step, copied):
    try:
      t0 = time.perf_counter()
      if copied is not None:
        copied.synchronize()
      tmp = os.path.join(self.directory, f"{step}{_TMP_SUFFIX}")
      shutil.rmtree(tmp, ignore_errors=True)
      os.makedirs(tmp)
      for entry, flat in host.items():
        np.savez(os.path.join(tmp, f"{entry}.npz"), **_flat_numpy(flat))
      final = os.path.join(self.directory, str(step))
      shutil.rmtree(final, ignore_errors=True)
      os.replace(tmp, final)
      self._prune()
      self.last_write_s = time.perf_counter() - t0
    except Exception as e:  # noqa: BLE001 -- raised by the next wait
      self._error = e

  def _prune(self):
    rolling = [s for s in self.all_steps()
               if not (self.keep_period and s % self.keep_period == 0)]
    for s in rolling[:-self.max_to_keep] if self.max_to_keep else rolling:
      shutil.rmtree(os.path.join(self.directory, str(s)), ignore_errors=True)

  def wait_until_finished(self):
    if self._thread is not None:
      self._thread.join()
      self._thread = None
    if self._error is not None:
      error, self._error = self._error, None
      raise RuntimeError("writing a checkpoint failed") from error

  def restore(self, step: Optional[int] = None, entries=None):
    """{entry: nested dict of CPU tensors} of `step` (default: the newest),
    all entries or only `entries`; None when there is no checkpoint."""
    step = step if step is not None else self.latest_step()
    if step is None:
      return None
    path = os.path.join(self.directory, str(step))
    names = sorted(n[:-len(".npz")] for n in os.listdir(path)
                   if n.endswith(".npz"))
    if entries is not None:
      missing = sorted(set(entries) - set(names))
      if missing:
        raise KeyError(f"checkpoint {path} has no entry {missing}; it has "
                       f"{names}")
      names = list(entries)
    return {n: load_params_npz(os.path.join(path, f"{n}.npz")) for n in names}


def make_manager(workdir: str, *, keep_period: Optional[int] = None,
                 max_to_keep: int = 1) -> Manager:
  """A manager writing under `{workdir}/checkpoints`."""
  return Manager(os.path.join(os.path.abspath(workdir), "checkpoints"),
                 keep_period=keep_period, max_to_keep=max_to_keep)


def save(mngr: Manager, state: Mapping, step: int):
  """Starts an asynchronous save of {entry: tree}; returns once the host
  copies are enqueued (the train loop keeps going)."""
  mngr.save(state, step)


def restore(mngr: Manager, step: Optional[int] = None):
  """Restores `step` (default: latest). Returns None if no checkpoint."""
  return mngr.restore(step)


def restore_subtree(mngr: Manager, key: str, step: Optional[int] = None):
  """Restores one top-level entry (e.g. just "params") of a checkpoint of
  the full state; only that entry's file is read."""
  restored = mngr.restore(step, entries=(key,))
  return None if restored is None else restored[key]


def latest_step(mngr: Manager) -> Optional[int]:
  return mngr.latest_step()


def wait_until_finished(mngr: Manager):
  mngr.wait_until_finished()
