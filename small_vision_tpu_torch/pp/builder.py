"""Composes `"fn1|fn2(…)"` pp strings into a host stage and a device stage.

Counterpart of small_vision_tpu/pp/builder.py. One pp string compiles into

  host_fn(example_dict)      per-example numpy (decode, crop, resize), run
                             by the input pipeline's workers;
  DevicePP                   the ops the trainer runs on whole batches on
                             the device after the uint8 images arrive there
                             (flip, value_range, onehot, ...).

The split point follows each op's registered stage: ops may interleave in
the string, but every host op must precede every device op ('any' ops bind
to the host until the first device op). Where the JAX device stage draws
from a jax key, a device op here is `(apply, draw)`: `draw(n, generator,
device)` makes its random draws from a `torch.Generator` and `apply(batch,
draws)` uses them, so a caller can inject the draws instead.
"""

from typing import Callable, Tuple

from small_vision_tpu_torch.pp import ops_general, ops_image  # noqa: F401
from small_vision_tpu_torch.pp.registry import Registry


def split_spec(pp_spec: str):
  """Splits a pp string into per-op spec strings, tolerating empty parts."""
  return [tok.strip() for tok in (pp_spec or "").split("|") if tok.strip()]


def _ops(pp_spec: str):
  """[(spec, what its factory returns, stage)], 'any' ops bound to the
  host until the first device op; raises on a host op after a device op."""
  ops, seen_device = [], False
  for spec in split_spec(pp_spec):
    fn, stage = Registry.lookup(spec)
    if stage == "any":
      stage = "device" if seen_device else "host"
    if stage == "host" and seen_device:
      raise ValueError(
          f"Host op {spec!r} appears after device ops in {pp_spec!r}; "
          "order ops host-first.")
    seen_device |= stage == "device"
    ops.append((spec, fn, stage))
  return ops


def split_stages(pp_spec: str) -> Tuple[str, str]:
  """(host_spec, device_spec) of a pp string, by `get_preprocess_fn`'s
  rule; lets callers compare the device stages of several pipelines
  (dataset mixing shares one device stage)."""
  ops = _ops(pp_spec)
  return ("|".join(s for s, _, st in ops if st == "host"),
          "|".join(s for s, _, st in ops if st == "device"))


class DevicePP:
  """The device stage of a pp string: `draw(n, generator, device)` makes
  the batch's random draws, `__call__(batch, draws)` applies the ops in
  order. A spec holding a host op raises."""

  def __init__(self, pp_spec: str):
    self.ops = []
    for spec in split_spec(pp_spec):
      fn, stage = Registry.lookup(spec)
      if stage == "host":
        raise ValueError(f"pp op {spec!r} of {pp_spec!r} is a host op; the "
                         "device stage takes device and 'any' ops only")
      if stage == "any":
        fn = ((lambda f: lambda batch, draws: f(batch))(fn), None)
      self.ops.append((spec, *fn))

  def draw(self, n, generator, device) -> dict:
    draws = {}
    for _, _, draw in self.ops:
      if draw is not None:
        draws.update(draw(n, generator, device))
    return draws

  def __call__(self, batch: dict, draws: dict) -> dict:
    batch = dict(batch)
    for _, apply, _ in self.ops:
      batch = apply(batch, draws)
    return batch


def get_preprocess_fn(pp_spec: str) -> Tuple[Callable, DevicePP]:
  """(host_fn, device_pp) of a pp string.

  host_fn: dict -> dict, applied per example on the host. When the first
  host op has a whole-chunk path (the fused JPEG decode and crop), host_fn
  has `batch(datas) -> datas`, or None where that path is unavailable (the
  caller then maps host_fn). device_pp: a `DevicePP`, empty where the
  string has no device op.
  """
  ops = _ops(pp_spec)
  host_ops = [(spec, fn) for spec, fn, stage in ops if stage == "host"]

  def host_fn(data):
    if not isinstance(data, dict):
      raise TypeError(f"pp data must be a dict, got {type(data)}")
    for spec, fn in host_ops:
      try:
        data = fn(data)
      except Exception as e:
        raise RuntimeError(f"pp host op {spec!r} failed: {e}") from e
    return data

  if host_ops and hasattr(host_ops[0][1], "batch"):
    def host_batch_fn(datas):
      datas = host_ops[0][1].batch(datas)
      if datas is None:
        return None
      for spec, fn in host_ops[1:]:
        try:
          datas = [fn(d) for d in datas]
        except Exception as e:
          raise RuntimeError(f"pp host op {spec!r} failed: {e}") from e
      return datas
    host_fn.batch = host_batch_fn

  return host_fn, DevicePP(
      "|".join(spec for spec, _, stage in ops if stage == "device"))
