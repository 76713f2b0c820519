"""The `key=val,flag` config arg-string minilanguage, on plain dicts.

Grammar (same as small_vision_tpu/configs/common.py::parse_arg):

  --config ae_i1k.py:variant=B/4,size=64,adaln=False
  --config amazing.py:runlocal          # bare flag -> True
  --config amazing.py:128               # first spec entry, positional

Each `get_config(arg)` declares a spec of defaults; values are converted with
the default's type (strict bool parsing: only 'true'/'false'/'').
"""


def _strict_bool(x: str) -> bool:
  low = x.lower()
  if low not in ("true", "false", ""):
    raise ValueError(f"Not a strict bool: {x!r}")
  return low == "true"


def parse_arg(arg, **spec) -> dict:
  """Parses the single-string config argument against a spec of defaults.

  Each value is converted with its default's type; unknown keys raise.
  """
  arg = arg or ""

  # Single token without '=' → bare flag, or positional first spec entry.
  if arg and "," not in arg and "=" not in arg:
    if arg in spec or not spec:
      arg = f"{arg}=True"
    else:
      arg = f"{next(iter(spec))}={arg}"

  raw = {}
  for tok in arg.split(","):
    if not tok:
      continue
    k, v = tok.split("=", 1) if "=" in tok else (tok, "True")
    raw[k] = v

  result = {}
  for name, default in spec.items():
    convert = _strict_bool if isinstance(default, bool) else type(default)
    result[name] = convert(raw.pop(name)) if name in raw else default
  if raw:
    raise ValueError(f"Unhandled config args remain: {raw}")
  return result
