"""Chrono: warmup-aware training telemetry.

Counterpart of small_vision_tpu/utils/chrono.py: images per second (and per
core), core-hours by device kind, ETA notes, and pause/resume bracketing so
that evaluation and checkpoint time does not pollute the throughput. Its
accumulated training time is saved with a checkpoint, so restarts keep
cumulative core-hours. Cores are the CUDA devices (1 on the CPU).
"""

import contextlib
import time

import numpy as np
import torch

from small_vision_tpu_torch.utils.misc import hms


class Chrono:
  """Measures time per training step, discounting paused (eval/ckpt) time.

  `clock` (seconds, monotonic) and `device` ("cuda" or "cpu": what `pause`
  synchronises and what names the core-hours) can be injected."""

  def __init__(self, device="cuda", clock=time.monotonic):
    self._clock = clock
    self.device = torch.device(device)
    self.program_start_time = clock()
    self.train_start_time = None
    self.train_start_step = None  # First step of timing (after warmup).
    self.prev_time = None
    self.prev_step = None
    self.pause_start = None
    self.paused_time = 0.0
    self.warmup_steps = 2  # Discard the first N steps (warm-up noise).
    self.note = "Chrono: n/a"
    # Informed later:
    self.total_steps = None
    self.global_bs = None
    self.steps_per_epoch = None
    self.first_step = None
    self.accum_train_time = 0.0
    self._measure = None
    self._write_note = None

  def inform(self, *, first_step=None, total_steps=None, global_bs=None,
             steps_per_epoch=None, measure=None, write_note=None):
    self.first_step = first_step if first_step is not None else self.first_step
    self.total_steps = (total_steps if total_steps is not None
                        else self.total_steps)
    self.global_bs = global_bs if global_bs is not None else self.global_bs
    self.steps_per_epoch = (steps_per_epoch if steps_per_epoch is not None
                            else self.steps_per_epoch)
    self._measure = measure or self._measure
    self._write_note = write_note or self._write_note
    if self.total_steps and self.first_step is not None:
      self.note = (f"Steps: {self.first_step}/{self.total_steps} "
                   f"[{self.first_step / self.total_steps:.1%}]")

  def _cores_and_kind(self):
    if self.device.type == "cuda":
      return torch.cuda.device_count(), torch.cuda.get_device_name(self.device)
    return 1, "cpu"

  def tick(self, step: int, measure=None, write_note=None):
    """Called on log steps; emits rate/ETA measurements."""
    measure = measure or self._measure
    write_note = write_note or self._write_note
    now = self._clock()

    # Warmup: skip timing until the first steps' noise has passed.
    if self.train_start_time is None:
      if self.prev_step is None:
        self.prev_step, self.prev_time = step, now
        return
      if step - self.prev_step >= self.warmup_steps:
        self.train_start_time = now
        self.train_start_step = step
        self.prev_step, self.prev_time = step, now
      return

    dstep = step - self.prev_step
    dtime = now - self.prev_time - self.paused_time
    if dstep == 0 or dtime <= 0:
      # Nothing measured: the paused time stays on the books. (The JAX
      # Chrono zeroes it here, so that a tick inside a pause, as the
      # evaluator cadence makes, forgets the pauses before it.)
      return
    self.paused_time = 0.0
    self.prev_step, self.prev_time = step, now
    self.accum_train_time += dtime

    ncores, devtype = self._cores_and_kind()
    secs_per_step = dtime / dstep
    imgs_per_sec = (self.global_bs or 0) / secs_per_step

    if measure:
      measure("z/secs_per_step", secs_per_step)
      if self.global_bs:
        measure("z/img_per_sec", imgs_per_sec)
        measure("z/img_per_sec_per_core", imgs_per_sec / ncores)
      if self.steps_per_epoch:
        measure("z/epoch", step / self.steps_per_epoch)
      core_hours = self.accum_train_time * ncores / 3600.0
      measure(f"z/core_hours_{devtype.replace(' ', '_')}", core_hours)

    if self.total_steps:
      eta = (self.total_steps - step) * secs_per_step
      done = step / self.total_steps
      self.note = (f"Steps: {step}/{self.total_steps} [{done:.1%}], "
                   f"ETA: {hms(eta)}, "
                   f"img/s: {imgs_per_sec:.1f}")
      if write_note:
        write_note(self.note)

  def pause(self, wait_for=()):
    """Starts a pause. The device is synchronised first, so that the step
    really ended; `wait_for` (the tensors the JAX Chrono blocks on) is
    accepted for its signature: a device-wide wait covers them."""
    assert self.pause_start is None, "Chrono: nested pause"
    del wait_for
    if self.device.type == "cuda":
      torch.cuda.synchronize(self.device)
    self.pause_start = self._clock()

  def resume(self):
    assert self.pause_start is not None, "Chrono: resume without pause"
    self.paused_time += self._clock() - self.pause_start
    self.pause_start = None

  def save(self):
    return np.asarray([self.accum_train_time], np.float64)

  def load(self, state):
    if isinstance(state, torch.Tensor):
      state = state.cpu().numpy()
    self.accum_train_time = float(np.asarray(state).reshape(-1)[0])

  @contextlib.contextmanager
  def log_timing(self, name, *, noop=False):
    """Context manager measuring a block's wall time as metric `name`."""
    t0 = self._clock()
    yield
    dt = self._clock() - t0
    if self._measure and not noop:
      self._measure(name, dt)
