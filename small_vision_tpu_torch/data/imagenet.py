"""ImageNet label metadata.

Counterpart of small_vision_tpu/data/imagenet.py: the 1,000 class names,
from an explicit file (one name per line) or from the on-disk cache that
the JAX package's TFDS lookup writes (`$SV_CLASS_NAMES_CACHE`, by default
`~/.cache/small_vision_tpu/imagenet_classes.txt`). The TFDS lookup itself
needs TensorFlow, which the port does not use: without a file or a cache
it raises, naming how to make one.
"""

import os
from typing import List, Optional


def default_cache() -> str:
  return os.environ.get(
      "SV_CLASS_NAMES_CACHE",
      os.path.join(os.path.expanduser("~"), ".cache", "small_vision_tpu",
                   "imagenet_classes.txt"))


def _read(path: str) -> List[str]:
  with open(path) as f:
    names = [line.strip() for line in f if line.strip()]
  if len(names) != 1000:
    raise ValueError(f"expected 1000 names in {path}, got {len(names)}")
  return names


def load_class_names(path: Optional[str] = None,
                     cache: Optional[str] = None) -> List[str]:
  """The 1,000 ImageNet class names, from `path` or the cache."""
  if path:
    return _read(path)
  cache = cache or default_cache()
  if os.path.exists(cache):
    return _read(cache)
  raise RuntimeError(
      f"No class-names file given and no cached export at {cache!r}. The "
      "names come from TFDS metadata, which needs TensorFlow: run `python "
      "-m small_vision_tpu.data.imagenet export <file>` once on a machine "
      "with TFDS and copy the file here (or to the cache path), or pass "
      "path= to load_class_names().")
