"""Generic preprocessing ops.

Counterpart of small_vision_tpu/pp/ops_general.py. Host ops manipulate
per-example numpy dicts; device ops run on batches of tensors and return
`(apply, draw)` (see pp/registry.py); 'any' ops are dict -> dict and run in
either stage.
"""

import numpy as np
import torch

from small_vision_tpu_torch.pp.registry import Registry
from small_vision_tpu_torch.pp.utils import InKeyOutKey


@Registry.register("value_range", stage="device")
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


@Registry.register("onehot", stage="device")
def get_onehot(depth: int, key: str = "labels", key_result: str = None,
               multi: bool = True, on: float = 1.0, off: float = 0.0):
  """Integer labels -> f32 one-hots; with `multi`, labels of more than one
  dimension give the max over their last axis (multi-label)."""

  def onehot(batch, draws):
    del draws
    labels = batch[key].long()
    if labels.ndim > 1 and multi:
      oh = torch.eye(depth, dtype=torch.float32,
                     device=labels.device)[labels].amax(dim=-2)
      oh = oh * (on - off) + off
    else:
      hit = labels[..., None] == torch.arange(depth, device=labels.device)
      oh = torch.where(hit, on, off).to(torch.float32)
    batch[key_result or key] = oh
    return batch
  return onehot, None


@Registry.register("keep", stage="any")
def get_keep(*keys):
  """Keeps only the named keys (and pipeline-internal '_' keys)."""

  def keep(data):
    return {k: v for k, v in data.items() if k in keys or k.startswith("_")}
  return keep


@Registry.register("drop", stage="any")
def get_drop(*keys):

  def drop(data):
    return {k: v for k, v in data.items() if k not in keys}
  return drop


@Registry.register("copy", stage="any")
def get_copy(inkey: str, outkey: str):

  def copy(data):
    v = data[inkey]
    if isinstance(v, np.ndarray):
      v = np.copy(v)
    elif isinstance(v, torch.Tensor):
      v = v.clone()
    data[outkey] = v
    return data
  return copy


@Registry.register("concat")
def get_concat(inkeys, outkey, axis=-1):
  """Concatenates several arrays into one key."""

  def concat(data):
    data[outkey] = np.concatenate([np.asarray(data[k]) for k in inkeys],
                                  axis=axis)
    return data
  return concat


@Registry.register("setdefault")
def get_setdefault(key, value):
  """Inserts a constant if the key is missing (e.g. labels of unlabelled
  data)."""

  def setdefault(data):
    if key not in data:
      data[key] = np.asarray(value)
    return data
  return setdefault


def _beta(p: float, generator, device, tries: int = 16) -> torch.Tensor:
  """One Beta(p, p) draw as X / (X + Y) of two Gamma(p) draws, each by
  Marsaglia and Tsang's method on Gamma(p + 1) scaled by U^(1/p). Each
  gamma draws `tries` candidates at once and takes the first accepted
  (every candidate is accepted with probability over 0.95 for p + 1 >= 1),
  so the draw never waits for the device."""
  d = p + 1.0 - 1.0 / 3.0
  c = 1.0 / (9.0 * d) ** 0.5
  kw = dict(generator=generator, device=device)

  def gamma():
    x = torch.randn(tries, **kw)
    u = torch.rand(tries, **kw)
    v = (1.0 + c * x) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                    + d * torch.log(v.clamp_min(1e-30)))
    first = torch.argmax(ok.to(torch.int32))
    boost = torch.rand((), **kw) ** (1.0 / p)
    return d * v[first] * boost

  g1, g2 = gamma(), gamma()
  return g1 / (g1 + g2)


@Registry.register("mixup", stage="device")
def get_mixup(p: float = 0.1, fold_in=("image",), alpha_key: str = "_mixup_a"):
  """Batch-level mixup: a = max(b, 1 - b) of one Beta(p, p) draw `b`
  (draws["mixup_beta"]), each tensor of `fold_in` mixed with its
  roll-by-one neighbour, a written to `alpha_key`."""

  def draw(n, generator, device):
    del n
    return {"mixup_beta": _beta(p, generator, device)}

  def mixup(batch, draws):
    b = draws["mixup_beta"].to(torch.float32)
    a = torch.maximum(b, 1.0 - b)
    for k in fold_in:
      x = batch[k]
      batch[k] = a * x + (1.0 - a) * torch.roll(x, 1, dims=0)
    batch[alpha_key] = a
    return batch
  return mixup, draw


@Registry.register("lookup")
def get_lookup(mapping, npzkey: str = "fnames", sep: str = None,
               key=None, inkey=None, outkey=None):
  """String -> index lookup from a mapping file (.npz of names, lines, or
  `name<sep>index` lines) or a dict."""
  key_kw = dict(key=key, inkey=inkey, outkey=outkey)
  if isinstance(mapping, str):
    if mapping.endswith(".npz"):
      keys = [k.decode() if hasattr(k, "decode") else str(k)
              for k in np.load(mapping)[npzkey]]
      table = {k: i for i, k in enumerate(keys)}
    else:
      with open(mapping) as f:
        lines = f.read().splitlines()
      if sep:
        table = dict(line.split(sep, 1) for line in lines)
        table = {k: int(v) for k, v in table.items()}
      else:
        table = {k: i for i, k in enumerate(lines)}
  else:
    table = dict(mapping)

  @InKeyOutKey(indefault="label", outdefault="label")
  def _lookup_factory():
    def lookup(value, data):
      del data
      v = value.decode() if isinstance(value, bytes) else str(value)
      return np.asarray(table[v], np.int32)
    return lookup
  return _lookup_factory(**{k: v for k, v in key_kw.items() if v})


@Registry.register("squeeze_last_dim")
@InKeyOutKey()
def get_squeeze_last_dim():

  def squeeze(x, data):
    del data
    return np.squeeze(np.asarray(x), axis=-1)
  return squeeze


@Registry.register("pad_to_shape")
@InKeyOutKey()
def get_pad_to_shape(shape, pad_value=0, where="after"):

  def pad(x, data):
    del data
    x = np.asarray(x)
    pads = []
    for want, have in zip(shape, x.shape):
      diff = 0 if want is None else want - have
      if diff < 0:
        raise ValueError(f"pad_to_shape: {x.shape} exceeds {shape}")
      pads.append({"after": (0, diff), "before": (diff, 0),
                   "both": (diff // 2, diff - diff // 2)}[where])
    return np.pad(x, pads, constant_values=pad_value)
  return pad


@Registry.register("flatten")
def get_flatten():
  """Flattens nested dicts into slash-joined keys."""

  def flatten(data):
    flat = {}

    def rec(prefix, d):
      for k, v in d.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
          rec(name, v)
        else:
          flat[name] = v
    rec("", data)
    return flat
  return flatten


@Registry.register("reshape")
@InKeyOutKey()
def get_reshape(new_shape):
  new_shape = tuple(new_shape)

  def reshape(x, data):
    del data
    return np.reshape(np.asarray(x), new_shape)
  return reshape


@Registry.register("choice")
def get_choice(n="single", key="image", fewer_ok=False):
  """Picks n random entries along axis 0 of data[key], from the example's
  `_rng`."""

  def choice(data):
    rng = data.get("_rng") or np.random.default_rng()
    arr = np.asarray(data[key])
    if n == "single":
      data[key] = arr[int(rng.integers(0, arr.shape[0]))]
    else:
      count = min(n, arr.shape[0]) if fewer_ok else n
      idx = rng.choice(arr.shape[0], size=count, replace=False)
      data[key] = arr[idx]
    return data
  return choice
