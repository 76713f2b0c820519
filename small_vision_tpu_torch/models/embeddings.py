"""Conditioning embedders: timestep, class label, and the 2-layer trunk.

Counterpart of small_vision_tpu/models/embeddings.py. The training-time
label drop to the null class (classifier-free guidance) takes its
Bernoulli mask from the caller; the timestep dropout is left out, as its
probability is 0 in every config. Parameter names follow the flax ones.
"""

import math

import torch
from torch import nn

from small_vision_tpu_torch.models.common import Dense


class TimestepEmbed(nn.Module):
  """Sinusoidal timestep embedding of (B,) int timesteps, in `dtype`.

  As in the JAX module, `freqs` and `t * freqs` are computed in `dtype`: in
  bf16 t itself rounds (993 becomes 992), and the product of two bf16
  values is rounded once. The constant is made a `dtype` tensor first, as
  JAX casts the weakly typed Python float to the array's dtype.
  """

  def __init__(self, width: int, dtype=torch.float32):
    super().__init__()
    self.width = width
    self.dtype = dtype

  def forward(self, t):
    t = t.reshape(t.shape[0], 1)
    half = self.width // 2
    c = torch.tensor(-math.log(10000.0) / (half - 1), dtype=self.dtype,
                     device=t.device)
    freqs = torch.exp(c * torch.arange(half, dtype=self.dtype,
                                       device=t.device))
    angles = t.to(self.dtype) * freqs
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


class _Embed(nn.Module):
  """flax nn.Embed: a (num, width) table named `embedding`."""

  def __init__(self, num: int, width: int):
    super().__init__()
    self.embedding = nn.Parameter(torch.empty(num, width))

  def forward(self, ids):
    return self.embedding[ids]


class LabelEmbed(nn.Module):
  """Class-label table with a trailing null class (index num_classes).

  `drop`: a (B,) bool mask, drawn Bernoulli(0.1) by the train step; where
  it is set, the label becomes the null class.
  """

  def __init__(self, width: int, num_classes: int):
    super().__init__()
    self.num_classes = num_classes
    self.embedding = _Embed(num_classes + 1, width)

  def forward(self, labels, drop=None):
    if drop is not None:
      labels = torch.where(drop, self.num_classes, labels)
    return self.embedding(labels)


class CondTrunk(nn.Module):
  """2-layer silu MLP; its Dense layers have no dtype, so they run in f32
  (the bf16 timestep embedding is promoted by the f32 kernel)."""

  def __init__(self, width: int, expansion: int = 2):
    super().__init__()
    self.Dense_0 = Dense(width, width * expansion, dtype=None)
    self.Dense_1 = Dense(width * expansion, width, dtype=None)

  def forward(self, x):
    return self.Dense_1(nn.functional.silu(self.Dense_0(x)))
