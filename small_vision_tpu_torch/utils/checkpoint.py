"""Flat-npz weights (the zoo format `export_sampler --weights_out` writes).

Counterpart of small_vision_tpu/utils/checkpoint.py::load_params_npz. numpy
has no bfloat16, so bf16 leaves are stored as uint16 bit-views under
`{name}::bf16`; they are decoded here into torch.bfloat16 tensors without
any third-party dtype package.
"""

import numpy as np
import torch

from small_vision_tpu_torch.utils.trees import recover_tree

_BF16_SUFFIX = "::bf16"


def load_params_npz(path: str) -> dict:
  """Nested dict of torch tensors from a flat `a/b/c`-keyed .npz."""
  keys, values = [], []
  with np.load(path) as data:
    for k, v in data.items():
      if k.endswith(_BF16_SUFFIX):
        k = k[:-len(_BF16_SUFFIX)]
        t = torch.from_numpy(np.ascontiguousarray(v).view(np.int16)).view(
            torch.bfloat16)
      else:
        t = torch.from_numpy(np.ascontiguousarray(v))
      keys.append(k)
      values.append(t)
  return recover_tree(keys, values)
