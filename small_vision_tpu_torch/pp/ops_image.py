"""Device-stage image ops, batched on the device.

Counterpart of the device ops of small_vision_tpu/pp/ops_image.py.
"""

import torch


def get_flip_lr():
  """Random horizontal flip per example: a (B,) bool draw `flip` (Bernoulli
  0.5), a reversed view and a select."""

  def draw(n, generator, device):
    return {"flip": torch.rand(n, generator=generator, device=device) < 0.5}

  def flip_lr(batch, draws):
    img = batch["image"]
    batch["image"] = torch.where(draws["flip"][:, None, None, None],
                                 img.flip(2), img)
    return batch
  return flip_lr, draw
