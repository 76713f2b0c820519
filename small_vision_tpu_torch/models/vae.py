"""The Stable Diffusion VAE (AutoencoderKL), in NCHW.

Counterpart of small_vision_tpu/models/vae.py: the SD v1.x configuration
(4 down and up blocks at (128, 256, 512, 512), two ResNet blocks a level in
the encoder and three in the decoder, a single-head self-attention in each
mid-block, 4-channel latents, scaling factor 0.18215). The modules carry
the flax module names (`encoder.down_0_res_0.norm1`, `mid_attn.to_q`, ...)
with PyTorch's parameter layouts: `Conv2d` weights (out, in, kh, kw),
`Linear` weights (out, in), `GroupNorm` `weight`/`bias` for flax's
`scale`/`bias`. `convert.vae_state_dict` / `vae_to_jax` bridge the two.

The public functions take and return channels-last tensors, (B, H, W, 3)
images in [-1, 1] and (B, H/8, W/8, 4) latents, as the JAX functions do;
inside, the tensors are their NCHW views (channels-last in memory, which
cuDNN takes as it is). Parameters and arithmetic are f32, flax's defaults.
Two places differ from flax in rounding only: `F.group_norm` takes the
variance in two passes where flax 0.12 takes E[x²] − E[x]², and the
convolutions sum in cuDNN's or the CPU's order.

No Pallas kernel is on this path in the JAX package (its convolutions,
GroupNorm and attention are plain XLA ops), so the port calls cuDNN,
`F.group_norm` and `torch.matmul` with a softmax.
"""

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from small_vision_tpu_torch.models.common import lecun_normal

SCALING_FACTOR = 0.18215
LATENT_CHANNELS = 4
SD_CHANNELS = (128, 256, 512, 512)
# Images a call of `load_vae`'s functions runs through the network at once:
# at 256 px one activation of the outer level is 32 MiB an image and 128
# channels, and whole training batches of them fragment the card's
# allocator between steps (8 GiB tensors at batch 256).
CHUNK = 32


def _conv(c_in, c_out, k):
  return nn.Conv2d(c_in, c_out, k, padding=k // 2)


def _group_norm(c):
  return nn.GroupNorm(32, c, eps=1e-6)


class ResnetBlock(nn.Module):

  def __init__(self, in_ch: int, out_ch: int):
    super().__init__()
    self.norm1 = _group_norm(in_ch)
    self.conv1 = _conv(in_ch, out_ch, 3)
    self.norm2 = _group_norm(out_ch)
    self.conv2 = _conv(out_ch, out_ch, 3)
    if in_ch != out_ch:
      self.conv_shortcut = _conv(in_ch, out_ch, 1)

  def forward(self, x):
    h = self.conv1(F.silu(self.norm1(x)))
    h = self.conv2(F.silu(self.norm2(h)))
    if hasattr(self, "conv_shortcut"):
      x = self.conv_shortcut(x)
    return x + h


class AttnBlock(nn.Module):
  """Single-head self-attention over the spatial positions: f32 logits
  scaled by 1/sqrt(c), the softmax, then `to_out` and the residual."""

  def __init__(self, ch: int):
    super().__init__()
    self.group_norm = _group_norm(ch)
    self.to_q = nn.Linear(ch, ch)
    self.to_k = nn.Linear(ch, ch)
    self.to_v = nn.Linear(ch, ch)
    self.to_out = nn.Linear(ch, ch)

  def forward(self, x):
    b, c, h, w = x.shape
    y = self.group_norm(x).flatten(2).transpose(1, 2)  # (b, h*w, c)
    q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
    logits = torch.matmul(q, k.transpose(1, 2)) / math.sqrt(c)
    y = torch.matmul(torch.softmax(logits.float(), dim=-1).to(v.dtype), v)
    y = self.to_out(y)
    return x + y.transpose(1, 2).reshape(b, c, h, w)


class Downsample(nn.Module):
  """Pads by (0, 1) on H and W, then a stride-2 VALID 3x3 convolution."""

  def __init__(self, ch: int):
    super().__init__()
    self.conv = nn.Conv2d(ch, ch, 3, stride=2)

  def forward(self, x):
    return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
  """Nearest-neighbour 2x, then a 3x3 convolution."""

  def __init__(self, ch: int):
    super().__init__()
    self.conv = _conv(ch, ch, 3)

  def forward(self, x):
    return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Encoder(nn.Module):

  def __init__(self, block_out_channels: Sequence[int] = SD_CHANNELS,
               layers_per_block: int = 2):
    super().__init__()
    chs = tuple(block_out_channels)
    self.conv_in = _conv(3, chs[0], 3)
    prev = chs[0]
    self.down = []
    for i, ch in enumerate(chs):
      for j in range(layers_per_block):
        self._add(f"down_{i}_res_{j}", ResnetBlock(prev, ch))
        prev = ch
      if i < len(chs) - 1:
        self._add(f"down_{i}_downsample", Downsample(ch))
    self.mid_res_0 = ResnetBlock(prev, prev)
    self.mid_attn = AttnBlock(prev)
    self.mid_res_1 = ResnetBlock(prev, prev)
    self.conv_norm_out = _group_norm(prev)
    self.conv_out = _conv(prev, 2 * LATENT_CHANNELS, 3)

  def _add(self, name, module):
    self.add_module(name, module)
    self.down.append(name)

  def forward(self, x):
    x = self.conv_in(x)
    for name in self.down:
      x = getattr(self, name)(x)
    x = self.mid_res_1(self.mid_attn(self.mid_res_0(x)))
    return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):

  def __init__(self, block_out_channels: Sequence[int] = SD_CHANNELS,
               layers_per_block: int = 3):
    super().__init__()
    rev = tuple(reversed(block_out_channels))
    self.conv_in = _conv(LATENT_CHANNELS, rev[0], 3)
    self.mid_res_0 = ResnetBlock(rev[0], rev[0])
    self.mid_attn = AttnBlock(rev[0])
    self.mid_res_1 = ResnetBlock(rev[0], rev[0])
    prev = rev[0]
    self.up = []
    for i, ch in enumerate(rev):
      for j in range(layers_per_block):
        self._add(f"up_{i}_res_{j}", ResnetBlock(prev, ch))
        prev = ch
      if i < len(rev) - 1:
        self._add(f"up_{i}_upsample", Upsample(ch))
    self.conv_norm_out = _group_norm(prev)
    self.conv_out = _conv(prev, 3, 3)

  def _add(self, name, module):
    self.add_module(name, module)
    self.up.append(name)

  def forward(self, z):
    x = self.conv_in(z)
    x = self.mid_res_1(self.mid_attn(self.mid_res_0(x)))
    for name in self.up:
      x = getattr(self, name)(x)
    return self.conv_out(F.silu(self.conv_norm_out(x)))


def _nchw(x):
  """The NCHW view of a channels-last (B, H, W, C) tensor."""
  return x.permute(0, 3, 1, 2)


def _nhwc(x):
  return x.permute(0, 2, 3, 1)


class AutoencoderKL(nn.Module):

  def __init__(self, block_out_channels: Sequence[int] = SD_CHANNELS):
    super().__init__()
    self.encoder = Encoder(block_out_channels)
    self.decoder = Decoder(block_out_channels)
    self.quant_conv = nn.Conv2d(2 * LATENT_CHANNELS, 2 * LATENT_CHANNELS, 1)
    self.post_quant_conv = nn.Conv2d(LATENT_CHANNELS, LATENT_CHANNELS, 1)

  def encode_moments(self, x):
    """(B, H, W, 3) in [-1, 1] → (mean, logvar), each (B, H/8, W/8, 4),
    the logvar clipped to [-30, 20]."""
    moments = _nhwc(self.quant_conv(self.encoder(_nchw(x.float()))))
    mean, logvar = moments.chunk(2, dim=-1)
    return mean, torch.clamp(logvar, -30.0, 20.0)

  def encode(self, x, noise=None, sample=True, scale=True):
    """z = mean + exp(logvar / 2) * noise (`noise`: N(0, 1) draws of the
    latent's shape, or a `torch.Generator` to draw them from; None, or
    `sample=False`, gives the mean), times SCALING_FACTOR when `scale`."""
    mean, logvar = self.encode_moments(x)
    z = mean
    if sample and noise is not None:
      if isinstance(noise, torch.Generator):
        noise = torch.randn(mean.shape, generator=noise, device=mean.device)
      z = mean + torch.exp(0.5 * logvar) * noise.to(mean.device, mean.dtype)
    return z * SCALING_FACTOR if scale else z

  def decode(self, z, scale=True):
    """(B, h, w, 4) latents → (B, 8h, 8w, 3) images."""
    z = z.float()
    if scale:
      z = z / SCALING_FACTOR
    return _nhwc(self.decoder(self.post_quant_conv(_nchw(z))))

  def forward(self, x, noise=None):
    return self.decode(self.encode(x, noise))


def init_vae_params(model: AutoencoderKL, seed: int = 0):
  """Fills `model`'s parameters from `seed` with flax's initialisers:
  lecun-normal convolution and Dense kernels (a normal truncated to ±2,
  scaled to variance 1/fan_in), zero biases, GroupNorm ones and zeros.
  The draws come from a CPU generator in sorted-name order, so a model on
  any device gets the same weights; they are not flax's draws."""
  gen = torch.Generator().manual_seed(seed)
  with torch.no_grad():
    for name, p in sorted(model.named_parameters()):
      owner = model.get_submodule(name.rsplit(".", 1)[0])
      if name.endswith(".bias"):
        p.zero_()
      elif isinstance(owner, nn.GroupNorm):
        p.fill_(1.0)
      else:
        p.copy_(lecun_normal(p.shape, math.prod(p.shape[1:]), gen))
  return model


def load_vae(weights_path: Optional[str] = None, image_size: int = 256,
             seed: int = 0, device="cuda",
             block_out_channels: Sequence[int] = SD_CHANNELS):
  """(vae_params, vae_encode, vae_decode), as the JAX `load_vae` returns.

  `vae_params`: {state_dict name: tensor} on `device`, from the npz of
  `scripts/convert_vae.py` when `weights_path` names one, else seeded
  (`init_vae_params`). `vae_encode(params, noise, images, scale=True)`:
  (B, H, W, 3) images in [-1, 1] → (B, H/8, W/8, 4) latents, `noise` the
  injected N(0, 1) draws or a `torch.Generator` (None: the mean).
  `vae_decode(params, latents, scale=True)` → (B, 8h, 8w, 3) images. Both
  run without gradients, `CHUNK` images at a time (a generator's noise is
  drawn for the whole batch first). `image_size` is the JAX signature's
  (flax's init traces an image of that size); the port's parameters do
  not depend on it.
  """
  del image_size
  from small_vision_tpu_torch import convert

  with torch.device("meta"):
    model = AutoencoderKL(block_out_channels)
  model = model.to_empty(device="cpu").requires_grad_(False)
  if weights_path:
    model.load_state_dict(convert.vae_state_dict(weights_path, model))
  else:
    init_vae_params(model, seed)
  model = model.to(device).eval()
  encode, decode = _bind(model, model.encode), _bind(model, model.decode)

  def vae_encode(params, noise, images, scale=True):
    b, h, w, _ = images.shape
    if isinstance(noise, torch.Generator):
      noise = torch.randn((b, h // 8, w // 8, LATENT_CHANNELS),
                          generator=noise, device=images.device)
    noises = [None] * b if noise is None else noise.split(CHUNK)
    return torch.cat([encode(params, x, n, scale=scale)
                      for x, n in zip(images.split(CHUNK), noises)])

  def vae_decode(params, latents, scale=True):
    return torch.cat([decode(params, z, scale=scale)
                      for z in latents.split(CHUNK)])
  return dict(model.state_dict()), vae_encode, vae_decode


def _bind(model: AutoencoderKL, fn):
  """fn(params, *args, **kw) without gradients, with `params` ({state_dict
  name: tensor}) standing in for the data of `model`'s parameters (nothing
  is copied; the model's own data is back afterwards)."""

  def call(params, *args, **kw):
    own = dict(model.named_parameters())
    if set(params) != set(own):
      raise KeyError(f"VAE params differ from the model's: missing "
                     f"{sorted(set(own) - set(params))[:8]}, left over "
                     f"{sorted(set(params) - set(own))[:8]}")
    saved = {n: p.data for n, p in own.items()}
    try:
      for n, p in own.items():
        p.data = params[n]
      with torch.no_grad():
        return fn(*args, **kw)
    finally:
      for n, p in own.items():
        p.data = saved[n]
  return call
