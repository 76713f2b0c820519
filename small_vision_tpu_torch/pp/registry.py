"""The registry of pp ops and the `"fn1|fn2(arg, k=v)"` grammar.

Counterpart of small_vision_tpu/pp/registry.py. Each op declares a stage:

  stage="host"    runs per example on numpy dicts (decode, crops, resizes);
                  its factory returns `fn(data) -> data`;
  stage="device"  runs on whole batches of tensors on the device, after the
                  host-to-device copy (flips, value ranges, one-hots); its
                  factory returns `(apply, draw)`: `apply(batch, draws)`
                  and `draw(n, generator, device)` making the op's random
                  draws, or None for a deterministic op;
  stage="any"     structural dict ops (keep, drop, copy) valid in either
                  stage; the builder binds them to the stage current at
                  their position. The factory returns `fn(data) -> data`.
"""

import ast
import contextlib
from typing import Any, Dict

_REGISTRY: Dict[str, Any] = {}
STAGES = ("host", "device", "any")


def parse_name(string_to_parse: str):
  """`"fn(1, k=2)"` -> ("fn", (1,), {"k": 2}), by the Python AST.

  Only literal arguments are allowed; a bare `"fn"` has none.
  """
  expr = ast.parse(string_to_parse, mode="eval").body
  if isinstance(expr, ast.Name):
    return expr.id, (), {}
  if isinstance(expr, ast.Attribute):
    raise ValueError(f"Dotted names not supported: {string_to_parse!r}")
  if not isinstance(expr, ast.Call):
    raise ValueError(f"Not a function call: {string_to_parse!r}")
  if not isinstance(expr.func, ast.Name):
    raise ValueError(f"Invalid function name in: {string_to_parse!r}")
  args = tuple(ast.literal_eval(a) for a in expr.args)
  kwargs = {kw.arg: ast.literal_eval(kw.value) for kw in expr.keywords}
  if None in kwargs:
    raise ValueError(f"**kwargs not supported: {string_to_parse!r}")
  return expr.func.id, args, kwargs


class Registry:
  """The process's pp op factories, by name."""

  @staticmethod
  def register(name: str, stage: str = "host", replace: bool = False):
    if stage not in STAGES:
      raise ValueError(f"pp op {name!r}: stage {stage!r} not in {STAGES}")

    def decorator(factory):
      if name in _REGISTRY and not replace:
        raise KeyError(f"pp op {name!r} already registered")
      factory.stage = stage
      _REGISTRY[name] = factory
      return factory
    return decorator

  @staticmethod
  def lookup(spec: str):
    """An op spec string -> (what its factory returns, its stage)."""
    name, args, kwargs = parse_name(spec)
    if name not in _REGISTRY:
      raise KeyError(f"Unknown pp op {name!r}. Known: {sorted(_REGISTRY)}")
    factory = _REGISTRY[name]
    return factory(*args, **kwargs), factory.stage

  @staticmethod
  def knows(name: str) -> bool:
    return name in _REGISTRY


@contextlib.contextmanager
def temporary_ops(**ops):
  """Registers throwaway ops for a block (a test's), then restores the
  registry."""
  saved = dict(_REGISTRY)
  try:
    for name, factory in ops.items():
      factory.stage = getattr(factory, "stage", "host")
      _REGISTRY[name] = factory
    yield
  finally:
    _REGISTRY.clear()
    _REGISTRY.update(saved)
