"""UMD weights between the reference's names and flax's, both ways.

Counterpart of small_vision_tpu/utils/convert_ref.py. The reference
(big_vision's `models/ae.py`) and the JAX package define the same UMD
with diverged parameter names and one diverged layout:

  reference                                  flax (the JAX package, the port)
  -----------------------------------------  ----------------------------
  {Enc,Dec}oder/ScanCheckpointEncoder1DBlock_0/  {Enc,Dec}oder/blocks/
  MultiHeadDotProductAttention_0             MultiHeadAttention_0
  image_mask_embedding                       mask_token
  label_emb/                                 label_embed/
  final_conv (ConvTranspose k=(p,p,W,2c))    head (Dense (W, p*p*2c), no bias)
  final_conv/bias (2c,)                      head_bias (2c, per-channel)

The final_conv <-> head mapping is exact both ways: a stride-p VALID
ConvTranspose whose kernel is the patch computes, per patch, the Dense
un-patchify with the kernel's taps spatially flipped (flax's
ConvTranspose without `transpose_kernel` flips them). The bias is
per-channel on both sides.

It composes with `convert.py`: `ref_to_ours` gives a flax-named tree in
the stacked (`blocks/`) layout, which `convert.params_from_jax` hands to
a model of either layout (`ref_state_dict` does both). Works on numpy
arrays (and CPU tensors, read as arrays).
"""

import numpy as np

from small_vision_tpu_torch import convert

_SCAN_BLOCK_REF = "ScanCheckpointEncoder1DBlock_0"
_SCAN_BLOCK_OURS = "blocks"
_NAME_MAP_REF_TO_OURS = {
    "image_mask_embedding": "mask_token",
    "label_emb": "label_embed",
}


def _flatten(tree, prefix=()):
  if isinstance(tree, dict):
    out = {}
    for k, v in tree.items():
      out.update(_flatten(v, prefix + (k,)))
    return out
  return {"/".join(prefix): np.asarray(tree)}


def _unflatten(flat):
  tree = {}
  for path, leaf in flat.items():
    node = tree
    keys = path.split("/")
    for k in keys[:-1]:
      node = node.setdefault(k, {})
    node[keys[-1]] = leaf
  return tree


def _rename(path: str, mapping, scan_from: str, scan_to: str) -> str:
  parts = [mapping.get(p, p) for p in path.split("/")]
  return "/".join(scan_to if p == scan_from else p for p in parts)


def head_from_final_conv(kernel: np.ndarray) -> np.ndarray:
  """ConvTranspose (p, p, width, C) kernel -> Dense (width, p*p*C): output
  pixel (i, j) of a patch reads the flipped tap K[p-1-i, p-1-j]."""
  p, p2, width, c = kernel.shape
  if p != p2:
    raise ValueError(f"final_conv kernel {kernel.shape} is not square")
  return kernel[::-1, ::-1].transpose(2, 0, 1, 3).reshape(width, p * p * c)


def final_conv_from_head(kernel: np.ndarray, patch: int) -> np.ndarray:
  """Dense (width, p*p*C) -> ConvTranspose (p, p, width, C). Exact."""
  width, pc = kernel.shape
  c = pc // (patch * patch)
  k = kernel.reshape(width, patch, patch, c).transpose(1, 2, 0, 3)
  return k[::-1, ::-1]  # undo the ConvTranspose's spatial flip


def ref_to_ours(ref_params, patch_size: int) -> dict:
  """A reference `_ViTAE` parameter tree (nested dicts) in flax's names,
  the block stacks in the stacked layout."""
  del patch_size  # the kernel's shape carries it
  flat = _flatten(ref_params)
  out = {}
  conv_kernel = conv_bias = None
  for path, leaf in flat.items():
    if path.startswith("final_conv/"):
      if path.endswith("kernel"):
        conv_kernel = leaf
      else:
        conv_bias = leaf
      continue
    new = _rename(path, _NAME_MAP_REF_TO_OURS, _SCAN_BLOCK_REF,
                  _SCAN_BLOCK_OURS)
    out[new.replace("MultiHeadDotProductAttention_0",
                    "MultiHeadAttention_0")] = leaf
  if conv_kernel is None or conv_bias is None:
    raise KeyError("reference checkpoint lacks final_conv")
  out["head/kernel"] = head_from_final_conv(conv_kernel)
  out["head_bias"] = np.asarray(conv_bias)
  return _unflatten(out)


def ours_to_ref(params, patch_size: int) -> dict:
  """A flax-named UMD tree back in the reference's names. Exact."""
  flat = _flatten(params)
  inv = {v: k for k, v in _NAME_MAP_REF_TO_OURS.items()}
  out = {}
  head_kernel = head_bias = None
  for path, leaf in flat.items():
    if path == "head_bias":
      head_bias = leaf
      continue
    if path.startswith("head/"):
      head_kernel = leaf
      continue
    new = _rename(path, inv, _SCAN_BLOCK_OURS, _SCAN_BLOCK_REF)
    out[new.replace("MultiHeadAttention_0",
                    "MultiHeadDotProductAttention_0")] = leaf
  if head_kernel is None or head_bias is None:
    raise KeyError("checkpoint lacks the Dense head")
  out["final_conv/kernel"] = final_conv_from_head(head_kernel, patch_size)
  out["final_conv/bias"] = np.asarray(head_bias)
  return _unflatten(out)


def ref_state_dict(ref_params, model) -> dict:
  """The port model's state_dict from reference-named weights: reference
  names -> flax names (`ref_to_ours`) -> the model's layout
  (`convert.params_from_jax`)."""
  return convert.params_from_jax(
      ref_to_ours(ref_params, model.patch), model)
