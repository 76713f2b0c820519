"""Device-stage generic ops, batched on the device.

Counterpart of the device and any-stage ops of
small_vision_tpu/pp/ops_general.py that the training pp string uses.
"""

import torch


def get_value_range(vmin: float = -1.0, vmax: float = 1.0,
                    in_min: float = 0.0, in_max: float = 255.0,
                    clip_values: bool = False, key: str = "image"):
  """Affine rescale from [in_min, in_max] to [vmin, vmax], in f32."""

  def value_range(batch, draws):
    del draws
    img = batch[key].to(torch.float32)
    img = vmin + (img - in_min) / (in_max - in_min) * (vmax - vmin)
    if clip_values:
      img = torch.clamp(img, vmin, vmax)
    batch[key] = img
    return batch
  return value_range, None


def get_keep(*keys):
  """Keeps only the named keys (and pipeline-internal '_' keys)."""

  def keep(batch, draws):
    del draws
    return {k: v for k, v in batch.items() if k in keys or k.startswith("_")}
  return keep, None
