"""The unified masked-diffusion auto-encoder (UMD), inference forward.

Counterpart of small_vision_tpu/models/ae.py::_ViTAE with mask=0: patchify,
timestep (and label) conditioning, the encoder with 4 averaged class tokens,
the decoder with the representation token, the AdaLN final modulation, the
Dense unpatchify to [x0 ‖ eps] with a per-channel bias, and the classifier-
free-guidance double batch. MAE masking (mask > 0) and `dual_forward` come
with the training slice. Parameter names follow the flax tree.

The patchify conv (VALID, stride = patch) is computed as a reshape and a
matmul on the (p·p·C, D) view of its HWIO kernel: the same function, with
no cuDNN convolution (and its TF32 default) on the path.
"""

from typing import Optional, Sequence

import torch
from torch import nn

from small_vision_tpu_torch.models.common import DTYPES, Dense, dense
from small_vision_tpu_torch.models.embeddings import (CondTrunk, LabelEmbed,
                                                      TimestepEmbed)
from small_vision_tpu_torch.models.vit import Encoder


class PatchEmbed(nn.Module):
  """flax nn.Conv(width, (p, p), strides=p, VALID): kernel (p, p, C, D)."""

  def __init__(self, patch: int, channels: int, width: int, dtype):
    super().__init__()
    self.patch = patch
    self.dtype = dtype
    self.kernel = nn.Parameter(torch.empty(patch, patch, channels, width))
    self.bias = nn.Parameter(torch.empty(width))

  def forward(self, image):  # (n, H, W, C) → (n, gh*gw, D)
    n, h, w, c = image.shape
    p = self.patch
    x = image.reshape(n, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(n, (h // p) * (w // p), p * p * c)
    return dense(x, self.kernel.reshape(p * p * c, -1), self.bias,
                 self.dtype)


class _ViTAE(nn.Module):

  def __init__(self, num_classes: Optional[int] = None, channels: int = 3,
               img_size: int = 64, patch_size: Sequence[int] = (4, 4),
               width: int = 768, depth: int = 12, dec_depth: int = 4,
               mlp_dim: Optional[int] = None, num_heads: int = 12,
               dtype_mm: str = "bfloat16", adaln: bool = False,
               num_cls: int = 4):
    super().__init__()
    p = patch_size[0]
    dtype = DTYPES[dtype_mm]
    self.num_classes = num_classes
    self.channels = channels
    self.patch = p
    self.grid = img_size // p
    self.width = width
    self.dtype = dtype
    self.adaln = adaln
    self.num_cls = num_cls
    num_patches = self.grid * self.grid

    self.time_embed = TimestepEmbed(width, dtype=dtype)
    self.time_trunk = CondTrunk(width, 2)
    if num_classes is not None:
      self.label_embed = LabelEmbed(width, num_classes)
      self.label_trunk = CondTrunk(width, 2)
    self.cls = nn.Parameter(torch.empty(1, num_cls, width))
    self.embedding = PatchEmbed(p, channels, width, dtype)
    self.pos_embedding = nn.Parameter(torch.empty(1, num_patches, width))
    self.dec_pos_embedding = nn.Parameter(torch.empty(1, num_patches, width))
    self.mask_token = nn.Parameter(torch.empty(1, 1, width))
    kw = dict(width=width, mlp_dim=mlp_dim, num_heads=num_heads, adaln=adaln,
              dtype=dtype)
    self.Encoder = Encoder(depth=depth, **kw)
    self.Decoder = Encoder(depth=dec_depth, **kw)
    if adaln:
      self.final_modulation = Dense(width, 2 * width, dtype)
    self.head = Dense(width, p * p * channels * 2, dtype, use_bias=False)
    self.head_bias = nn.Parameter(torch.empty(2 * channels))

  def embed(self, image, t=None, y=None):
    """Patchify + the conditioning vector from (t, y)."""
    x = self.embedding(image.to(self.dtype))
    n = x.shape[0]
    if t is None:
      t = torch.zeros((n,), dtype=torch.long, device=x.device)
    time_cond = self.time_trunk(self.time_embed(t))
    if self.num_classes is not None:
      if y is None:
        y = torch.full((n,), self.num_classes, dtype=torch.long,
                       device=x.device)
      y_cond = self.label_trunk(self.label_embed(y))
    else:
      if y is not None:
        raise ValueError("y given but model has num_classes=None")
      y_cond = torch.zeros((n, self.width), dtype=self.dtype,
                           device=x.device)
    cond = time_cond + y_cond
    if self.adaln:
      cond = nn.functional.silu(cond)
    return x, cond.to(self.dtype)

  def encode(self, x, cond):
    n = x.shape[0]
    x = x + self.pos_embedding.to(x.dtype)
    x = torch.cat([self.cls.to(x.dtype).expand(n, -1, -1), x], dim=1)
    x = self.Encoder(x, cond)
    rep = x[:, :self.num_cls].mean(dim=1)  # averaged class tokens
    return rep, x[:, self.num_cls:], {"mask": None, "pre_logits": rep}

  def decode(self, rep, x, cond):
    # The encoder's final LN emits f32. (Mask-token restore goes here with
    # the training slice.)
    return self._decode_restored(rep, x.to(self.dtype), cond)

  def _decode_restored(self, rep, x, cond):
    """Decoder + final modulation + head on an already-unmasked sequence."""
    x = x + self.dec_pos_embedding.to(x.dtype)
    x = torch.cat([rep[:, None, :].to(x.dtype), x], dim=1)
    x = self.Decoder(x, cond)[:, 1:, :]
    if self.adaln:
      shift, scale = self.final_modulation(cond).chunk(2, dim=-1)
      # (1 + scale) is rounded to the compute dtype before it meets the
      # f32 stream, as in the JAX module.
      x = x * (1 + scale[:, None, :]) + shift[:, None, :]
    x = self.head(x)  # (n, L, p*p*2c)
    n, p, g = x.shape[0], self.patch, self.grid
    out = x.reshape(n, g, g, p, p, -1).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(n, g * p, g * p, -1).float()
    return out + self.head_bias  # per-channel, ConvTranspose-bias semantics

  def forward(self, image, *, t=None, y=None, cfg_scale=None, mask=0.0):
    """Returns (pred, out) with pred = [x0_hat ‖ eps_hat], NHWC f32.

    `cfg_scale`: classifier-free guidance; the batch is doubled with null
    labels and the prediction extrapolated from uncond towards cond.
    """
    if mask > 0.0:
      raise NotImplementedError("MAE masking comes with the training slice")
    if cfg_scale is not None:
      if y is None or self.num_classes is None:
        raise ValueError("cfg_scale needs labels and num_classes")
      n = image.shape[0]
      image = torch.cat([image, image], dim=0)
      t = torch.cat([t, t], dim=0)
      null_y = torch.full((n,), self.num_classes, dtype=torch.long,
                          device=y.device)
      y = torch.cat([y, null_y], dim=0)

    x, cond = self.embed(image, t=t, y=y)
    rep, encoded, out = self.encode(x, cond)
    pred = self.decode(rep, encoded, cond)

    if cfg_scale is not None:
      conditional, unconditional = pred.chunk(2, dim=0)
      pred = unconditional + cfg_scale * (conditional - unconditional)
    return pred, out


def decode_variant(variant):
  """UMD variant table: "B/4" → dims (MAE-style decoder depth scaling)."""
  if variant is None:
    return {}
  v, patch = variant, {}
  if "/" in variant:
    v, p = variant.split("/")
    patch = {"patch_size": (int(p), int(p))}
  return {
      "width": {"S": 384, "B": 768, "L": 1024}[v],
      "depth": {"S": 12, "B": 12, "L": 24}[v],
      "dec_depth": {"S": 4, "B": 4, "L": 8}[v],
      "num_heads": {"S": 6, "B": 12, "L": 16}[v],
      **patch,
  }


def Model(*, variant=None, **kw):  # noqa: N802 (factory, as in JAX package)
  return _ViTAE(**{**decode_variant(variant), **kw})
