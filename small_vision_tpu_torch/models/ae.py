"""The unified masked-diffusion auto-encoder (UMD).

Counterpart of small_vision_tpu/models/ae.py::_ViTAE: patchify, timestep
(and label) conditioning, MAE random masking in the encoder, the encoder
with 4 averaged class tokens, the mask-token restore and the decoder with
the representation token, the AdaLN final modulation, the Dense unpatchify
to [x0 ‖ eps] with a per-channel bias, the classifier-free-guidance double
batch, and `dual_forward`, the training forward that shares one decoder
pass between the MAE and diffusion branches. Parameter names follow the
flax tree.

The draws the JAX module takes from its rng streams are arguments here:
`mask_noise` ((B, L) uniforms for `random_masking`, the "mae_noise"
stream) and `label_drop` ((B,) bool, the "cfg" stream, used with
`train=True`), and with `dropout` > 0 `dropout_draw`, a function of a
shape that returns a keep mask (the "dropout" stream; `models.vit`), used
with `train=True`. `attn_impl` ("pallas", "pallas_fused", "xla" or "flax")
picks the blocks' attention configuration (see `models.vit`); the
parameters are the same under all. `scan` puts the encoder's and the
decoder's blocks in flax `nn.scan`'s stacked layout, and `remat_policy`
rematerialises them as JAX does (`models.vit.Encoder`). The JAX module
defaults to `scan=True`; the port to False (every config passes it).
`quant` ("" or "none", "int8_mlp", "int8_all") puts the blocks' MLP
products, or all their products but the attention core's, through the
int8 matmul (`ops/quant.py`).

The patchify conv (VALID, stride = patch) is computed as a reshape and a
matmul on the (p·p·C, D) view of its HWIO kernel: the same function, with
no cuDNN convolution (and its TF32 default) on the path.

`pipe_stages > 1` pipelines the encoder's and the decoder's stacks over
the active mesh's `pipe` axis (`models.vit.Encoder`; both depths must
divide by it), with `pipe_microbatches` microbatches (default 4 S).
"""

from typing import Optional, Sequence

import torch
from torch import nn

from small_vision_tpu_torch.models.common import (DTYPES, Dense, dense,
                                                  patchify)
from small_vision_tpu_torch.models.embeddings import (CondTrunk, LabelEmbed,
                                                      TimestepEmbed)
from small_vision_tpu_torch.models.vit import Encoder, training_draw
from small_vision_tpu_torch.ops.masking import (random_masking,
                                                restore_masked,
                                                sequence_mask_to_image_mask)

# The model's `quant` values and the blocks' (JAX models/ae.py).
BLOCK_QUANT = {"int8_mlp": "int8", "int8_all": "int8_all", "none": "none",
          "": "none"}


class PatchEmbed(nn.Module):
  """flax nn.Conv(width, (p, p), strides=p, VALID): kernel (p, p, C, D)."""

  def __init__(self, patch: int, channels: int, width: int, dtype):
    super().__init__()
    self.patch = patch
    self.dtype = dtype
    self.kernel = nn.Parameter(torch.empty(patch, patch, channels, width))
    self.bias = nn.Parameter(torch.empty(width))

  def forward(self, image):  # (n, H, W, C) → (n, gh*gw, D)
    p = self.patch
    x = patchify(image, (p, p))
    x = x.reshape(x.shape[0], -1, x.shape[-1])
    return dense(x, self.kernel.reshape(x.shape[-1], -1), self.bias,
                 self.dtype)


class _ViTAE(nn.Module):

  def __init__(self, num_classes: Optional[int] = None, channels: int = 3,
               img_size: int = 64, patch_size: Sequence[int] = (4, 4),
               width: int = 768, depth: int = 12, dec_depth: int = 4,
               mlp_dim: Optional[int] = None, num_heads: int = 12,
               dtype_mm: str = "bfloat16", adaln: bool = False,
               num_cls: int = 4, dropout: float = 0.0,
               cfg_dropout_rate: float = 0.1, attn_impl: str = "pallas",
               quant: str = "none", scan: bool = False,
               remat_policy: Optional[str] = "nothing_saveable",
               pipe_stages: int = 0, pipe_microbatches: int = 0):
    super().__init__()
    p = patch_size[0]
    self.dropout = dropout
    dtype = DTYPES[dtype_mm]
    self.num_classes = num_classes
    self.cfg_dropout_rate = cfg_dropout_rate  # the train step's label drop
    self.channels = channels
    self.patch = p
    self.img_size = img_size
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
    if quant not in BLOCK_QUANT:
      raise ValueError(f"quant={quant!r}: one of {sorted(BLOCK_QUANT)}")
    kw = dict(width=width, mlp_dim=mlp_dim, num_heads=num_heads, adaln=adaln,
              dtype=dtype, attn_impl=attn_impl, quant=BLOCK_QUANT[quant],
              scan=scan, remat_policy=remat_policy, dropout=dropout,
              pipe_stages=pipe_stages, pipe_microbatches=pipe_microbatches)
    self.Encoder = Encoder(depth=depth, **kw)
    self.Decoder = Encoder(depth=dec_depth, **kw)
    if adaln:
      self.final_modulation = Dense(width, 2 * width, dtype)
    self.head = Dense(width, p * p * channels * 2, dtype, use_bias=False)
    self.head_bias = nn.Parameter(torch.empty(2 * channels))

  def embed(self, image, t=None, y=None, label_drop=None):
    """Patchify + the conditioning vector from (t, y); `label_drop` drops
    labels to the null class (training)."""
    x = self.embedding(image.to(self.dtype))
    n = x.shape[0]
    if t is None:
      t = torch.zeros((n,), dtype=torch.long, device=x.device)
    time_cond = self.time_trunk(self.time_embed(t))
    if self.num_classes is not None:
      if y is None:
        y = torch.full((n,), self.num_classes, dtype=torch.long,
                       device=x.device)
      y_cond = self.label_trunk(self.label_embed(y, label_drop))
    else:
      if y is not None:
        raise ValueError("y given but model has num_classes=None")
      y_cond = torch.zeros((n, self.width), dtype=self.dtype,
                           device=x.device)
    cond = time_cond + y_cond
    if self.adaln:
      cond = nn.functional.silu(cond)
    return x, cond.to(self.dtype)

  def encode(self, x, cond, mask=0.0, mask_noise=None, dropout_draw=None):
    """Encoder; with `mask` > 0 only the tokens `mask_noise` keeps."""
    n = x.shape[0]
    x = x + self.pos_embedding.to(x.dtype)
    out = {"mask": None}
    ids_restore = None
    if mask > 0.0:
      if mask_noise is None:
        raise ValueError("mask > 0 needs the (B, L) mask_noise draws")
      x, seq_mask, ids_restore = random_masking(x, mask, mask_noise)
      out["mask"] = sequence_mask_to_image_mask(seq_mask, self.patch,
                                                self.img_size)
    x = torch.cat([self.cls.to(x.dtype).expand(n, -1, -1), x], dim=1)
    x = self.Encoder(x, cond, dropout_draw)
    rep = x[:, :self.num_cls].mean(dim=1)  # averaged class tokens
    out["pre_logits"] = rep
    return rep, x[:, self.num_cls:], ids_restore, out

  def _unmask(self, x, ids_restore):
    x = x.to(self.dtype)  # The encoder's final LN emits f32.
    if ids_restore is not None:
      x = restore_masked(x, self.mask_token, ids_restore)
    return x

  def decode(self, rep, x, cond, ids_restore=None, dropout_draw=None):
    return self._decode_restored(rep, self._unmask(x, ids_restore), cond,
                                 dropout_draw)

  def _decode_restored(self, rep, x, cond, dropout_draw=None):
    """Decoder + final modulation + head on an already-unmasked sequence."""
    x = x + self.dec_pos_embedding.to(x.dtype)
    x = torch.cat([rep[:, None, :].to(x.dtype), x], dim=1)
    x = self.Decoder(x, cond, dropout_draw)[:, 1:, :]
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

  def _label_drop(self, train, label_drop):
    if label_drop is not None and not train:
      raise ValueError("label_drop is a training draw; pass train=True")
    return label_drop

  def forward(self, image, *, t=None, y=None, cfg_scale=None, mask=0.0,
              train=False, mask_noise=None, label_drop=None,
              dropout_draw=None):
    """Returns (pred, out) with pred = [x0_hat ‖ eps_hat], NHWC f32, and
    out["mask"] the (B, H, W, 1) pixel mask (None at mask 0).

    `cfg_scale`: classifier-free guidance; the batch is doubled with null
    labels and the prediction extrapolated from uncond towards cond.
    `mask_noise`: (B, L) uniforms, needed when `mask` > 0. `label_drop`:
    (B,) bool, with `train`, drops labels to the null class.
    `dropout_draw`: with `train` and dropout > 0, a function of a shape
    that returns a bool keep mask.
    """
    label_drop = self._label_drop(train, label_drop)
    draw = training_draw(train, self.dropout, dropout_draw)
    if cfg_scale is not None:
      if train:
        raise ValueError("cfg_scale is inference-only")
      if y is None or self.num_classes is None:
        raise ValueError("cfg_scale needs labels and num_classes")
      n = image.shape[0]
      image = torch.cat([image, image], dim=0)
      t = torch.cat([t, t], dim=0)
      null_y = torch.full((n,), self.num_classes, dtype=torch.long,
                          device=y.device)
      y = torch.cat([y, null_y], dim=0)

    x, cond = self.embed(image, t=t, y=y, label_drop=label_drop)
    rep, encoded, ids_restore, out = self.encode(x, cond, mask, mask_noise,
                                                 draw)
    pred = self.decode(rep, encoded, cond, ids_restore, draw)

    if cfg_scale is not None:
      conditional, unconditional = pred.chunk(2, dim=0)
      pred = unconditional + cfg_scale * (conditional - unconditional)
    return pred, out

  def dual_forward(self, img_a, img_b, *, t_a=None, t_b=None, y_a=None,
                   y_b=None, mask_a=0.0, mask_b=0.0, train=False,
                   noise_a=None, noise_b=None, label_drop=None,
                   dropout_draw=None):
    """Two-branch training forward sharing one embed/decoder/head pass.

    The branches (clean MAE and noised diffusion) are concatenated wherever
    their shapes agree; only the encoders (different keep-lengths) run per
    branch. `noise_a`/`noise_b` are each branch's mask draws and
    `label_drop` the (n_a + n_b,) label-drop mask of the concatenated
    batch. Returns (pred, out_a, out_b) with pred ordered [a ‖ b].
    """
    label_drop = self._label_drop(train, label_drop)
    draw = training_draw(train, self.dropout, dropout_draw)
    n_a = img_a.shape[0]
    image = torch.cat([img_a.to(self.dtype), img_b.to(self.dtype)], dim=0)
    n = image.shape[0]
    dev = image.device
    zeros = lambda m: torch.zeros((m,), dtype=torch.long, device=dev)
    t = torch.cat([t_a if t_a is not None else zeros(n_a),
                   t_b if t_b is not None else zeros(n - n_a)], dim=0)
    y = None
    if self.num_classes is not None:
      null = lambda m: torch.full((m,), self.num_classes, dtype=torch.long,
                                  device=dev)
      y = torch.cat([y_a if y_a is not None else null(n_a),
                     y_b if y_b is not None else null(n - n_a)], dim=0)
    elif y_a is not None or y_b is not None:
      raise ValueError("labels given but model has num_classes=None")

    x, cond = self.embed(image, t=t, y=y, label_drop=label_drop)
    rep_a, enc_a, ids_a, out_a = self.encode(x[:n_a], cond[:n_a], mask_a,
                                             noise_a, draw)
    rep_b, enc_b, ids_b, out_b = self.encode(x[n_a:], cond[n_a:], mask_b,
                                             noise_b, draw)
    full = torch.cat([self._unmask(enc_a, ids_a), self._unmask(enc_b, ids_b)],
                     dim=0)
    rep = torch.cat([rep_a, rep_b], dim=0)
    return self._decode_restored(rep, full, cond, draw), out_a, out_b


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
