"""The data-source registry.

Counterpart of small_vision_tpu/data/core.py::get for the sources the port
has: `synthetic`. A source offers `total_examples`,
`num_examples_per_process`, `examples(ordered=...)`, `peek()` and, being
random-access, `epoch_index` / `take` for gathering batches in bulk. The
ImageNet, array and latent sources come with the data slice.
"""

import importlib

_KNOWN = {"synthetic": "small_vision_tpu_torch.data.synthetic"}


def get(name: str, **kw):
  """The source `name`, built with `kw` (e.g. `split="validation"`)."""
  if name.startswith("mod:"):
    return importlib.import_module(name[4:]).DataSource(**kw)
  if name not in _KNOWN:
    raise ValueError(f"data source {name!r}: the port has {sorted(_KNOWN)} "
                     "(ImageNet, arrays and latents come with the data "
                     "slice)")
  return importlib.import_module(_KNOWN[name]).DataSource(**kw)
