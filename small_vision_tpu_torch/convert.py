"""Bridge between flax param trees and the port's state_dicts.

The port's modules carry the flax names and shapes, so a flax leaf
`Encoder/blocks_00/MultiHeadAttention_0/query/kernel` (768, 12, 64) is the
state_dict entry `Encoder.blocks_00.MultiHeadAttention_0.query.kernel` of the
same shape. The bridge checks that the two name sets are equal and the
shapes agree, and raises on any name left over or missing.

`init_params` draws a non-degenerate flax-named tree from a seed with numpy.
Every leaf is drawn, including the ones flax zero-initialises (the AdaLN
`Dense_0`, `final_modulation`, `cls`, `head_bias`): with AdaLN-zero weights
every gate is 0, each attention and MLP output is multiplied by zero, and a
broken kernel would still give the "right" samples.
"""

from typing import Mapping

import numpy as np
import torch

from small_vision_tpu_torch.utils.trees import (recover_tree,
                                                tree_flatten_with_names)


def _flat(params) -> dict:
  """{slash name: leaf} of a nested or already-flat mapping."""
  if any(isinstance(v, Mapping) for v in params.values()):
    return dict(tree_flatten_with_names(params))
  return dict(params)


def _as_tensor(leaf) -> torch.Tensor:
  if isinstance(leaf, torch.Tensor):
    return leaf
  return torch.from_numpy(np.array(leaf))  # np.array: an owned, writable copy


def params_from_jax(params, model: torch.nn.Module) -> dict:
  """state_dict for `model` from a flax-named tree (nested or `a/b/c`-flat)
  of numpy arrays or tensors. Raises KeyError on a leftover or missing
  name and ValueError on a shape mismatch."""
  got = {k.replace("/", "."): v for k, v in _flat(params).items()}
  want = model.state_dict()
  missing = sorted(set(want) - set(got))
  leftover = sorted(set(got) - set(want))
  if missing or leftover:
    raise KeyError(f"param names differ from the model's: missing "
                   f"{missing[:8]}{'...' if len(missing) > 8 else ''}, "
                   f"left over {leftover[:8]}"
                   f"{'...' if len(leftover) > 8 else ''}")
  out = {}
  for name, ref in want.items():
    t = _as_tensor(got[name])
    if tuple(t.shape) != tuple(ref.shape):
      raise ValueError(f"{name}: shape {tuple(t.shape)} != model's "
                       f"{tuple(ref.shape)}")
    out[name] = t
  return out


def params_to_jax(state_dict) -> dict:
  """Nested flax-named tree of float32 numpy arrays from a state_dict."""
  names = [k.replace(".", "/") for k in state_dict]
  values = [v.detach().float().cpu().numpy() for v in state_dict.values()]
  return recover_tree(names, values)


def _std_and_mean(name: str, shape) -> tuple:
  parts = name.split("/")
  leaf = parts[-1]
  if leaf == "kernel":
    # Unit-variance outputs from unit-variance inputs. The fan-in is every
    # axis but the last, except for the (d, H, hd) q/k/v kernels.
    fan_in = (shape[0] if parts[-2] in ("query", "key", "value")
              else int(np.prod(shape[:-1])))
    return 1.0 / np.sqrt(fan_in), 0.0
  if leaf == "scale":  # LayerNorm gains around 1.
    return 0.1, 1.0
  if leaf in ("bias", "head_bias"):
    return 0.1, 0.0
  if leaf in ("pos_embedding", "dec_pos_embedding"):
    return 1.0 / np.sqrt(shape[1]), 0.0  # flax's init scale
  return 1.0, 0.0  # cls, mask_token, label embedding table


def init_params(config: dict, seed: int) -> dict:
  """Nested flax-named tree of float32 numpy arrays for the config's model,
  drawn from `np.random.default_rng(seed)` in sorted-name order."""
  from small_vision_tpu_torch.train.train_ae import build_model
  shapes = {k.replace(".", "/"): tuple(v.shape) for k, v in
            build_model(config, device="meta").state_dict().items()}
  names = sorted(shapes)
  rng = np.random.default_rng(seed)
  values = []
  for name in names:
    std, mean = _std_and_mean(name, shapes[name])
    a = rng.standard_normal(shapes[name], dtype=np.float32)
    values.append(a * np.float32(std) + np.float32(mean))
  return recover_tree(names, values)
