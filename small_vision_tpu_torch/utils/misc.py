"""Small stateless helpers.

Counterpart of small_vision_tpu/utils/misc.py for what one process on one
card needs: `itstime`, `hms`, `make_grid` and `log_timing`. The cross-process
helpers (`sync`, `pad_shard_unpad`, `accumulate_gradient`) come with the
parallelism slice.
"""

import contextlib
import math
import time

import numpy as np
import torch


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
