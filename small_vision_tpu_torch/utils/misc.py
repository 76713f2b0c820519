"""Small stateless helpers.

Counterpart of small_vision_tpu/utils/misc.py: `itstime`, `hms`,
`make_grid`, `log_timing`, and the cross-process helpers `sync`,
`pad_shard_unpad` and `accumulate_gradient`.
"""

import contextlib
import math
import time

import numpy as np
import torch

from small_vision_tpu_torch.utils.trees import tree_leaves, tree_map


def itstime(step, every_n_steps, total_steps, last=True, first=True,
            drop_close_to_last=0.25):
  """True when a periodic action should run at `step`: every
  `every_n_steps`, also on the final step when `last` and on step 1 when
  `first`; a periodic hit that lands within `drop_close_to_last *
  every_n_steps` of the end is skipped."""
  if not every_n_steps:
    return False
  close_to_last = bool(
      drop_close_to_last and
      abs(step - total_steps) < drop_close_to_last * every_n_steps)
  is_periodic = step % every_n_steps == 0 and not close_to_last
  is_last = step == total_steps
  is_first = step == 1
  return bool(is_periodic or (last and is_last) or (first and is_first))


def hms(seconds: float) -> str:
  """Formats a duration as e.g. '1h23m45s' (no leading zero units)."""
  seconds = int(round(seconds))
  h, rem = divmod(seconds, 3600)
  m, s = divmod(rem, 60)
  if h:
    return f"{h}h{m}m{s}s"
  if m:
    return f"{m}m{s}s"
  return f"{s}s"


def to_numpy(x) -> np.ndarray:
  """A tensor (on any device) or array-like as a numpy array."""
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().numpy()
  return np.asarray(x)


def make_grid(images, num_samples=36):
  """Tiles the first `num_samples` images into a square grid (numpy, HWC)."""
  if isinstance(images, dict):
    images = images.get("samples", next(iter(images.values())))
  images = to_numpy(images)[:num_samples]
  n = images.shape[0]
  side = int(math.ceil(math.sqrt(n)))
  h, w, c = images.shape[1:]
  grid = np.zeros((side * h, side * w, c), dtype=images.dtype)
  for i in range(n):
    r, col = divmod(i, side)
    grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = images[i]
  return grid


@contextlib.contextmanager
def log_timing(measure_fn, name: str, device=None):
  """Times a block and reports its seconds via `measure_fn(name, secs)`.

  With a CUDA `device` the time is the device's, between two CUDA events on
  the current stream (the block's kernels, not their launches); without, the
  host's monotonic clock."""
  if device is not None and torch.device(device).type == "cuda":
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    end.synchronize()
    measure_fn(name, start.elapsed_time(end) / 1e3)
    return
  t0 = time.monotonic()
  yield
  measure_fn(name, time.monotonic() - t0)


def sync():
  """A barrier over every process: an all-reduce of one per process, whose
  sum must be the process count. One process: nothing to wait for."""
  from small_vision_tpu_torch.parallel import collectives
  from small_vision_tpu_torch.parallel import mesh as mesh_lib
  total = collectives.all_reduce_host([1.0])
  assert int(total[0]) == mesh_lib.process_count(), total


def pad_shard_unpad(wrapped, static_argnums=(0,), static_argnames=(),
                    num_shards=None):
  """Wraps `wrapped` so that a batch that does not divide by the shard count
  (default: the process count) is zero-padded up to a multiple of it (at
  least `min_device_batch` rows a shard, a keyword the wrapper adds), and
  the outputs with a leading batch dim are cut back to the batch."""
  def wrapper(*args, min_device_batch=None, **kw):
    from small_vision_tpu_torch.parallel import mesh as mesh_lib
    d = num_shards or mesh_lib.process_count()
    sizes = set()
    for i, a in enumerate(args):
      if i not in static_argnums:
        sizes |= {t.shape[0] for t in tree_leaves(a)}
    for k, v in kw.items():
      if k not in static_argnames:
        sizes |= {t.shape[0] for t in tree_leaves(v)}
    assert len(sizes) == 1, f"Inconsistent batch sizes: {sizes}"
    b = sizes.pop()
    db = -(-b // d)
    if min_device_batch and db < min_device_batch:
      db = min_device_batch

    def pad(x):
      if not hasattr(x, "shape") or db * d == b:
        return x
      if isinstance(x, torch.Tensor):
        return torch.cat([x, x.new_zeros((db * d - b,) + tuple(x.shape[1:]))])
      return np.concatenate(
          [np.asarray(x), np.zeros((db * d - b,) + x.shape[1:], x.dtype)])

    args = [a if i in static_argnums else tree_map(pad, a)
            for i, a in enumerate(args)]
    kw = {k: v if k in static_argnames else tree_map(pad, v)
          for k, v in kw.items()}
    out = wrapped(*args, **kw)
    return tree_map(lambda x: x[:b] if hasattr(x, "shape") and len(x.shape)
                and x.shape[0] >= b else x, out)
  return wrapper


def accumulate_gradient(loss_and_grad_fn, params, batch, accum_steps):
  """(loss, grads) of `loss_and_grad_fn(params, batch)` taken over
  `accum_steps` equal microbatches of the batch (dim 0) and averaged, in
  the JAX order: the first microbatch's, plus the others' in turn, times
  1 / accum_steps. `grads` is a list (or dict) of tensors."""
  if not accum_steps or accum_steps <= 1:
    return loss_and_grad_fn(params, batch)
  micro = lambda i: tree_map(lambda x: x.reshape(
      (accum_steps, x.shape[0] // accum_steps) + tuple(x.shape[1:]))[i], batch)
  total_l, total_g = loss_and_grad_fn(params, micro(0))
  for i in range(1, accum_steps):
    l, g = loss_and_grad_fn(params, micro(i))
    total_l = total_l + l
    total_g = tree_map(lambda a, b: a + b, total_g, g)
  scale = 1.0 / accum_steps
  return total_l * scale, tree_map(lambda g: g * scale, total_g)
