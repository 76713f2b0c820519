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
broken kernel would still give the "right" samples. The tests and the
smoke use it.

`init_train_params` draws the tree training starts from: each leaf from
the distribution its JAX module declares (the AdaLN-zero init included,
which the JAX package's training relies on). It matches the
distributions, not the bits.

`opt_state_from_jax` carries a JAX run's optimizer state (optax's
ScaleByAdamState: count, bf16 mu, f32 nu) and EMA params, as numpy trees,
into the port's `optim.AdamW` state, so the run can continue in the port;
`train_state_from_jax` / `train_state_to_jax` do so for the whole of a
train state that crosses (parameters, EMA, optimizer).
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
  a = np.array(leaf)  # an owned, writable copy
  if a.dtype.name == "bfloat16":  # ml_dtypes' bf16, as JAX hands it over
    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
  return torch.from_numpy(a)


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


_TRUNC_STD = 0.87962566103423978  # std of a normal truncated to ±2


def _truncated_normal(rng, shape):
  """Standard normal truncated to ±2, as jax.random.truncated_normal."""
  a = rng.standard_normal(shape)
  while True:
    bad = np.abs(a) > 2.0
    if not bad.any():
      return a
    a[bad] = rng.standard_normal(int(bad.sum()))


def _train_init(name: str, shape, rng) -> np.ndarray:
  """One leaf as the JAX module initialises it (models/ae.py, vit.py,
  embeddings.py and flax's defaults)."""
  parts = name.split("/")
  leaf, parent = parts[-1], (parts[-2] if len(parts) > 1 else "")
  grand = parts[-3] if len(parts) > 2 else ""
  normal = lambda std: rng.standard_normal(shape) * std
  zeros = lambda: np.zeros(shape)

  def xavier(fan_in, fan_out):
    limit = np.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-limit, limit, shape)

  def lecun(fan_in):
    return _truncated_normal(rng, shape) * (np.sqrt(1.0 / fan_in) /
                                            _TRUNC_STD)

  if leaf == "scale":                       # LayerNorms
    return np.ones(shape)
  if name in ("cls", "head_bias") or parent == "final_modulation":
    return zeros()
  if parent == "Dense_0" and grand.startswith("blocks_"):  # AdaLN-zero
    return zeros()
  if leaf in ("pos_embedding", "dec_pos_embedding"):
    return normal(1.0 / np.sqrt(shape[1]))
  if name == "mask_token" or parent == "head":
    return normal(0.02)
  if parent in ("query", "key", "value", "out"):
    if leaf == "bias":
      return zeros()
    # xavier_uniform on the 2-D (d, H*hd) / (H*hd, d) view.
    fan_in = shape[0] if parent != "out" else shape[0] * shape[1]
    return xavier(fan_in, int(np.prod(shape)) // fan_in)
  if grand.startswith("MlpBlock"):
    return xavier(*shape) if leaf == "kernel" else normal(1e-6)
  if leaf == "bias":
    return zeros()
  if leaf == "embedding":  # nn.Embed: variance_scaling(1, fan_in, normal)
    return lecun(shape[1])
  if leaf == "kernel":     # nn.Dense / nn.Conv: lecun_normal
    return lecun(int(np.prod(shape[:-1])))
  raise KeyError(f"no initialiser for {name}")


def init_train_params(config: dict, seed: int) -> dict:
  """Nested flax-named tree of float32 numpy arrays that training starts
  from, drawn from `np.random.default_rng(seed)` in sorted-name order."""
  from small_vision_tpu_torch.train.train_ae import build_model
  shapes = {k.replace(".", "/"): tuple(v.shape) for k, v in
            build_model(config, device="meta").state_dict().items()}
  names = sorted(shapes)
  rng = np.random.default_rng(seed)
  values = [_train_init(n, shapes[n], rng).astype(np.float32) for n in names]
  return recover_tree(names, values)


def opt_state_from_jax(names, *, count, mu, nu, ema_params=None,
                       device="cpu"):
  """(AdamW state, EMA list or None) for the parameters `names` (flax
  names, in the port's order) from a JAX run's ScaleByAdamState fields
  and EMA params, given as nested or flat flax-named numpy trees."""
  def as_list(tree, dtype):
    flat = _flat(tree)
    if set(flat) != set(names):
      raise KeyError(f"names differ: missing {sorted(set(names) - set(flat))[:8]}"
                     f", left over {sorted(set(flat) - set(names))[:8]}")
    out = []
    for n in names:
      t = _as_tensor(flat[n])
      if t.dtype != dtype:
        raise ValueError(f"{n}: dtype {t.dtype}, want {dtype}")
      out.append(t.to(device))
    return out

  state = {"count": int(np.asarray(count)),
           "mu": as_list(mu, torch.bfloat16),
           "nu": as_list(nu, torch.float32)}
  ema = None if ema_params is None else as_list(ema_params, torch.float32)
  return state, ema


def train_state_from_jax(state, names, device="cpu") -> dict:
  """The port's {"params", "opt"[, "ema_params"]} (lists in `names` order,
  the port's parameter order) from a JAX train state dumped as numpy:
  {"params": tree, "opt": {"count", "mu", "nu"} (the fields of optax's
  ScaleByAdamState: `mu` bf16, `nu` f32)[, "ema_params": tree]}, trees
  nested or flat, flax-named. The lists line up with a live train state's
  (`train_ae.init_train_state`), into whose tensors they are copied.

  The random state is not carried: a JAX PRNG key and a `torch.Generator`
  are different generators, so a run that crosses draws other noise from
  there on (its `rng` and `gd` entries are ignored; the port rebuilds the
  diffusion tables from the config).
  """
  flat = _flat(state["params"])
  if set(flat) != set(names):
    raise KeyError(f"names differ: missing {sorted(set(names) - set(flat))[:8]}"
                   f", left over {sorted(set(flat) - set(names))[:8]}")
  opt = state["opt"]
  opt_state, ema = opt_state_from_jax(
      names, count=opt["count"], mu=opt["mu"], nu=opt["nu"],
      ema_params=state.get("ema_params"), device=device)
  out = {"params": [_as_tensor(flat[n]).to(device) for n in names],
         "opt": opt_state}
  if ema is not None:
    out["ema_params"] = ema
  return out


def train_state_to_jax(train_state, names) -> dict:
  """The reverse of `train_state_from_jax`: nested flax-named numpy trees
  {"params", "opt": {"count", "mu", "nu"}[, "ema_params"]} of a port train
  state. numpy has no bfloat16, so `mu` comes as float32 holding the bf16
  values exactly; cast it to bfloat16 on the JAX side."""
  tree = lambda tensors: recover_tree(
      names, [t.detach().float().cpu().numpy() for t in tensors])
  opt = train_state["opt"]
  out = {"params": tree(train_state["params"]),
         "opt": {"count": np.asarray(opt["count"], np.int32),
                 "mu": tree(opt["mu"]), "nu": tree(opt["nu"])}}
  if "ema_params" in train_state:
    out["ema_params"] = tree(train_state["ema_params"])
  return out
