"""Configs as plain dicts, addressed as `name.py:arg-string`."""

import importlib
import os


def parse_config(spec: str) -> dict:
  """`ae_i1k.py:key=val,...` → the config dict of that module."""
  path, arg = spec.split(":", 1) if ":" in spec else (spec, None)
  name = os.path.basename(path)
  if name.endswith(".py"):
    name = name[:-3]
  module = importlib.import_module(f"small_vision_tpu_torch.configs.{name}")
  return module.get_config(arg)
