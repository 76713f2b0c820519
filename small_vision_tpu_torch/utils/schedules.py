"""Durations in config entries, resolved to steps.

Counterpart of small_vision_tpu/utils/schedules.py::steps.
"""

from typing import Optional


def steps(prefix: str, config, data_size: Optional[int] = None,
          batch_size: Optional[int] = None,
          total_steps: Optional[int] = None, default=ValueError):
  """Resolves a duration config entry to an integer number of steps.

  Accepts any one of `{prefix}_steps`, `{prefix}_examples`,
  `{prefix}_epochs`, `{prefix}_percent` in `config` (a dict). Raises if
  more than one is set, or none and no default.
  """
  options = {}
  for unit in ("steps", "examples", "epochs", "percent"):
    v = config.get(f"{prefix}_{unit}")
    if v is not None:
      options[unit] = v
  if len(options) > 1:
    raise ValueError(
        f"Ambiguous duration for '{prefix}': multiple units set {options}")
  if not options:
    if default is ValueError:
      raise ValueError(
          f"Missing duration '{prefix}_(steps|examples|epochs|percent)'.")
    return default

  unit, value = options.popitem()
  if unit == "steps":
    return int(value)
  if unit == "examples":
    if not batch_size:
      raise ValueError(f"'{prefix}_examples' needs batch_size")
    return max(int(value // batch_size), 1)
  if unit == "epochs":
    if not (batch_size and data_size):
      raise ValueError(f"'{prefix}_epochs' needs data and batch size")
    return max(int(value * data_size / batch_size), 1)
  if total_steps is None:
    raise ValueError(f"'{prefix}_percent' needs total_steps")
  if not 0.0 <= value <= 1.0:
    raise ValueError(f"percent must be in [0,1], got {value}")
  return max(int(value * total_steps), 1)
