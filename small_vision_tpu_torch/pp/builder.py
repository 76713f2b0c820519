"""Composes the device stage of a `"fn1|fn2(…)"` pp string.

Counterpart of small_vision_tpu/pp/builder.py for the device stage only:
the ops the trainer runs on whole batches on the device, after the uint8
images arrive there. Each op is a factory `get_<name>(*args, **kwargs)`
returning `(apply, draw)`: `apply(batch, draws)` transforms the batch dict
and `draw(n, generator, device)` (None for a deterministic op) makes the
op's random draws, so a caller can inject them instead. Host-stage ops
(decoding, cropping) come with the data slice; a spec with any op not
registered here raises.
"""

import ast

from small_vision_tpu_torch.pp import ops_general, ops_image

DEVICE_OPS = {
    "flip_lr": ops_image.get_flip_lr,
    "value_range": ops_general.get_value_range,
    "keep": ops_general.get_keep,
}


def split_spec(pp_spec: str):
  """Splits a pp string into per-op spec strings, tolerating empty parts."""
  return [tok.strip() for tok in (pp_spec or "").split("|") if tok.strip()]


def parse_op(spec: str):
  """`name(1, b="x")` → ("name", (1,), {"b": "x"}); a bare name has no
  arguments. Arguments must be Python literals."""
  node = ast.parse(spec, mode="eval").body
  if isinstance(node, ast.Name):
    return node.id, (), {}
  if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)):
    raise ValueError(f"pp op {spec!r} is not of the form name(args)")
  args = tuple(ast.literal_eval(a) for a in node.args)
  kwargs = {k.arg: ast.literal_eval(k.value) for k in node.keywords}
  return node.func.id, args, kwargs


class DevicePP:
  """The device stage of a pp string: `draw` makes the step's random draws,
  `__call__(batch, draws)` applies the ops in order."""

  def __init__(self, pp_spec: str):
    self.ops = []
    for spec in split_spec(pp_spec):
      name, args, kwargs = parse_op(spec)
      if name not in DEVICE_OPS:
        raise ValueError(f"pp op {name!r} of {pp_spec!r} is not ported; the "
                         f"port has {sorted(DEVICE_OPS)}")
      self.ops.append((spec, *DEVICE_OPS[name](*args, **kwargs)))

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
