"""InceptionV3, the FID variant of pytorch-fid, as NCHW `nn.Module`s.

Counterpart of small_vision_tpu/evaluators/inception.py, with its FID
quirks:
  - BasicConv2d = a convolution without bias, BatchNorm with eps 1e-3 on
    its running statistics, relu;
  - every average pool of the towers excludes the zero padding from its
    divisor (`count_include_pad=False`);
  - Mixed_7c (the last InceptionE) max-pools its pool branch;
  - pool3 is the 2048-d mean over the last feature map, and the head has
    1008 outputs.
Module names follow the flax tree (`Mixed_5b.branch5x5_2.conv`), and each
BatchNorm keeps flax's leaf names (`scale`, `bias`, `mean`, `var`), so
`convert.inception_state_dict` bridges a flax tree, or the npz of
`scripts/convert_inception.py`, by name.

The repository has no Inception weights: `init_params()` without a path
draws seeded ones (the FID pipeline's shapes and arithmetic, not its
numbers); a user brings the npz.
"""

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

FEATURE_DIM = 2048
NUM_CLASSES = 1008
BN_EPS = 1e-3


class BatchNorm(nn.Module):
  """flax nn.BatchNorm(use_running_average=True, epsilon=1e-3)."""

  def __init__(self, channels: int):
    super().__init__()
    self.scale = nn.Parameter(torch.empty(channels))
    self.bias = nn.Parameter(torch.empty(channels))
    self.register_buffer("mean", torch.empty(channels))
    self.register_buffer("var", torch.empty(channels))

  def forward(self, x):
    return F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                        training=False, eps=BN_EPS)


class BasicConv2d(nn.Module):

  def __init__(self, in_channels: int, out_channels: int, kernel,
               stride: int = 1, padding=0):
    super().__init__()
    self.conv = nn.Conv2d(in_channels, out_channels, kernel, stride=stride,
                          padding=padding, bias=False)
    self.bn = BatchNorm(out_channels)

  def forward(self, x):
    return F.relu(self.bn(self.conv(x)))


def _max_pool(x, window=3, stride=2, padding=0):
  return F.max_pool2d(x, window, stride, padding)


def _avg_pool(x, window=3, stride=1, padding=1, count_include_pad=True):
  return F.avg_pool2d(x, window, stride, padding,
                      count_include_pad=count_include_pad)


class InceptionA(nn.Module):

  def __init__(self, in_channels: int, pool_features: int):
    super().__init__()
    self.branch1x1 = BasicConv2d(in_channels, 64, 1)
    self.branch5x5_1 = BasicConv2d(in_channels, 48, 1)
    self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
    self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, 1)
    self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
    self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
    self.branch_pool = BasicConv2d(in_channels, pool_features, 1)

  def forward(self, x):
    b1 = self.branch1x1(x)
    b5 = self.branch5x5_2(self.branch5x5_1(x))
    b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
    bp = self.branch_pool(_avg_pool(x, 3, 1, 1, count_include_pad=False))
    return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):

  def __init__(self, in_channels: int):
    super().__init__()
    self.branch3x3 = BasicConv2d(in_channels, 384, 3, stride=2)
    self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, 1)
    self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
    self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

  def forward(self, x):
    b3 = self.branch3x3(x)
    bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
    return torch.cat([b3, bd, _max_pool(x, 3, 2)], dim=1)


class InceptionC(nn.Module):

  def __init__(self, in_channels: int, channels_7x7: int):
    super().__init__()
    c7 = channels_7x7
    self.branch1x1 = BasicConv2d(in_channels, 192, 1)
    self.branch7x7_1 = BasicConv2d(in_channels, c7, 1)
    self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
    self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
    self.branch7x7dbl_1 = BasicConv2d(in_channels, c7, 1)
    self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
    self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
    self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
    self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
    self.branch_pool = BasicConv2d(in_channels, 192, 1)

  def forward(self, x):
    b1 = self.branch1x1(x)
    b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
    bd = self.branch7x7dbl_1(x)
    for i in range(2, 6):
      bd = getattr(self, f"branch7x7dbl_{i}")(bd)
    bp = self.branch_pool(_avg_pool(x, 3, 1, 1, count_include_pad=False))
    return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):

  def __init__(self, in_channels: int):
    super().__init__()
    self.branch3x3_1 = BasicConv2d(in_channels, 192, 1)
    self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
    self.branch7x7x3_1 = BasicConv2d(in_channels, 192, 1)
    self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
    self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
    self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

  def forward(self, x):
    b3 = self.branch3x3_2(self.branch3x3_1(x))
    b7 = self.branch7x7x3_1(x)
    for i in range(2, 5):
      b7 = getattr(self, f"branch7x7x3_{i}")(b7)
    return torch.cat([b3, b7, _max_pool(x, 3, 2)], dim=1)


class InceptionE(nn.Module):
  """`pool_type` "avg" (Mixed_7b, padding excluded from the divisor) or
  "max" (Mixed_7c) in the pool branch."""

  def __init__(self, in_channels: int, pool_type: str = "avg"):
    super().__init__()
    if pool_type not in ("avg", "max"):
      raise ValueError(f"pool_type {pool_type!r}: 'avg' or 'max'")
    self.pool_type = pool_type
    self.branch1x1 = BasicConv2d(in_channels, 320, 1)
    self.branch3x3_1 = BasicConv2d(in_channels, 384, 1)
    self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
    self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
    self.branch3x3dbl_1 = BasicConv2d(in_channels, 448, 1)
    self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
    self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
    self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
    self.branch_pool = BasicConv2d(in_channels, 192, 1)

  def forward(self, x):
    b1 = self.branch1x1(x)
    b3 = self.branch3x3_1(x)
    b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
    bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
    bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                   dim=1)
    if self.pool_type == "avg":
      bp = _avg_pool(x, 3, 1, 1, count_include_pad=False)
    else:
      bp = _max_pool(x, 3, 1, padding=1)
    return torch.cat([b1, b3, bd, self.branch_pool(bp)], dim=1)


class InceptionV3(nn.Module):
  """(B, 3, 299, 299) in [-1, 1] -> (pool3 (B, 2048), logits (B, 1008))."""

  def __init__(self, num_classes: int = NUM_CLASSES):
    super().__init__()
    self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
    self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
    self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
    self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
    self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
    self.Mixed_5b = InceptionA(192, 32)
    self.Mixed_5c = InceptionA(256, 64)
    self.Mixed_5d = InceptionA(288, 64)
    self.Mixed_6a = InceptionB(288)
    self.Mixed_6b = InceptionC(768, 128)
    self.Mixed_6c = InceptionC(768, 160)
    self.Mixed_6d = InceptionC(768, 160)
    self.Mixed_6e = InceptionC(768, 192)
    self.Mixed_7a = InceptionD(768)
    self.Mixed_7b = InceptionE(1280, "avg")
    self.Mixed_7c = InceptionE(2048, "max")
    self.fc = nn.Linear(FEATURE_DIM, num_classes)

  def forward(self, x):
    x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
    x = _max_pool(x, 3, 2)
    x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
    x = _max_pool(x, 3, 2)
    for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b",
                 "Mixed_6c", "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b",
                 "Mixed_7c"):
      x = getattr(self, name)(x)
    pool3 = x.mean(dim=(2, 3))
    return pool3, self.fc(pool3)


def seeded_state_dict(model: nn.Module, seed: int) -> dict:
  """A state_dict of non-degenerate weights drawn from
  `np.random.default_rng(seed)` in sorted-name order: He-scaled
  convolutions (activations stay O(1) through the relus), BatchNorm
  statistics and affines around their identities, a fan-in-scaled head."""
  rng = np.random.default_rng(seed)
  out = {}
  for name, ref in sorted(model.state_dict().items()):
    shape = tuple(ref.shape)
    leaf = name.rsplit(".", 1)[-1]
    normal = rng.standard_normal(shape)
    if name == "fc.weight":
      a = normal / np.sqrt(shape[1])
    elif leaf == "weight":  # a convolution, (O, I, kh, kw)
      a = normal * np.sqrt(2.0 / np.prod(shape[1:]))
    elif leaf == "scale":
      a = 1.0 + 0.1 * normal
    elif leaf == "var":
      a = rng.uniform(0.5, 1.5, shape)
    else:  # bn bias, bn mean, fc bias
      a = 0.1 * normal
    out[name] = torch.from_numpy(a.astype(np.float32))
  return out


def init_params(weights_path: Optional[str] = None, *, seed: int = 0,
                device="cuda") -> InceptionV3:
  """InceptionV3 in eval mode on `device`: the weights of a converted npz
  (`scripts/convert_inception.py`'s slash-keyed layout), or seeded ones."""
  from small_vision_tpu_torch import convert
  with torch.device("meta"):
    model = InceptionV3()
  if weights_path:
    with np.load(weights_path) as data:
      state = convert.inception_state_dict(dict(data.items()), model)
  else:
    state = seeded_state_dict(model, seed)
  model = model.to_empty(device=device)
  model.load_state_dict(state)
  return model.eval().requires_grad_(False)
