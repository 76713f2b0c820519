"""Bridge between flax param trees and the port's state_dicts.

The port's modules carry the flax names and shapes, so a flax leaf
`Encoder/blocks_00/MultiHeadAttention_0/query/kernel` (768, 12, 64) is the
state_dict entry `Encoder.blocks_00.MultiHeadAttention_0.query.kernel` of the
same shape. The bridge checks that the two name sets are equal and the
shapes agree, and raises on any name left over or missing. One layout
differs: a 4-D `weight` (the classifier's patch conv `embedding`, torch's
OIHW Conv2d layout) is flax's HWIO `kernel` of the same module, transposed
each way.

The blocks come in two layouts, as in flax: unrolled
(`Encoder/blocks_00/...`, `blocks_01`, ...) and stacked, `nn.scan`'s
(`Encoder/blocks/...`, each leaf with the depth on a leading axis), which
a `scan=True` model holds. `stack_blocks` and `unstack_blocks` turn a tree
(parameters, or AdamW's mu or nu, keyed alike) from one into the other,
exactly; `params_from_jax`, `opt_state_from_jax` and
`train_state_from_jax` take either layout and hand the model the one it
holds, and `params_to_jax` gives either.

`init_params` draws a non-degenerate flax-named tree from a seed with numpy.
Every leaf is drawn, including the ones flax zero-initialises (the AdaLN
`Dense_0`, `final_modulation`, `cls`, `head_bias`): with AdaLN-zero weights
every gate is 0, each attention and MLP output is multiplied by zero, and a
broken kernel would still give the "right" samples. The tests and the
smoke use it.

`init_train_params` draws the tree training starts from: each leaf from
the distribution its JAX module declares (the AdaLN-zero init included,
which the JAX package's training relies on). It matches the
distributions, not the bits. A model module may declare its own
initialisers for some leaves (`init_leaf`, as `models/vit.py` does for the
classifier's posemb, head and `probe`); flax's defaults and the UMD's
cover the rest.

`opt_state_from_jax` carries a JAX run's optimizer state (optax's
ScaleByAdamState: count, bf16 mu, f32 nu) and EMA params, as numpy trees,
into the port's `optim.AdamW` state, so the run can continue in the port;
`train_state_from_jax` / `train_state_to_jax` do so for the whole of a
train state that crosses (parameters, EMA, optimizer).

`inception_state_dict` bridges FID's InceptionV3 from the flax variables
({"params", "batch_stats"}, nested) or the slash-keyed npz that
`scripts/convert_inception.py` writes (`params/Mixed_5b/branch1x1/conv/
kernel`, `batch_stats/.../bn/mean`): HWIO convolution kernels become
OIHW, the (2048, 1008) head kernel its transpose, the BatchNorm leaves
keep their names. `inception_to_jax` is its inverse.
"""

import re
from typing import Mapping, Optional

import numpy as np
import torch

from small_vision_tpu_torch import models
from small_vision_tpu_torch.models.common import (np_lecun_normal,
                                                 np_xavier_uniform)
from small_vision_tpu_torch.utils.trees import (recover_tree,
                                                tree_flatten_with_names)


def _flat(params) -> dict:
  """{slash name: leaf} of a nested or already-flat mapping."""
  if any(isinstance(v, Mapping) for v in params.values()):
    return dict(tree_flatten_with_names(params))
  return dict(params)


_UNROLLED = re.compile(r"^(.*?)(?:^|/)blocks_(\d+)/(.*)$")
_STACKED = re.compile(r"^(.*?)(?:^|/)blocks/(.*)$")


def _join(prefix, name):
  return f"{prefix}/{name}" if prefix else name


def _stack(leaves):
  if isinstance(leaves[0], torch.Tensor):
    return torch.stack(leaves)
  return np.stack([np.asarray(a) for a in leaves])


def _same_form(params, flat: dict):
  """`flat` nested again if `params` was nested."""
  if any(isinstance(v, Mapping) for v in params.values()):
    return recover_tree(list(flat), list(flat.values()))
  return flat


def stack_blocks(params):
  """The tree (nested or slash-flat) with every `.../blocks_NN/<leaf>`
  group stacked, in the order of NN, into `.../blocks/<leaf>`: flax
  `nn.scan`'s layout. numpy leaves or tensors; other leaves unchanged."""
  flat = _flat(params)
  out, groups = {}, {}
  for name, leaf in flat.items():
    m = _UNROLLED.match(name)
    if m is None:
      out[name] = leaf
    else:
      groups.setdefault((m.group(1), m.group(3)), {})[int(m.group(2))] = leaf
  for (prefix, rest), layers in groups.items():
    if sorted(layers) != list(range(len(layers))):
      raise KeyError(f"{_join(prefix, 'blocks_NN/' + rest)}: layers "
                     f"{sorted(layers)} are not 0..{len(layers) - 1}")
    out[_join(prefix, f"blocks/{rest}")] = _stack(
        [layers[i] for i in range(len(layers))])
  return _same_form(params, out)


def unstack_blocks(params):
  """The inverse of `stack_blocks`: every `.../blocks/<leaf>` split along
  its leading (depth) axis into `.../blocks_NN/<leaf>`."""
  flat = _flat(params)
  out = {}
  for name, leaf in flat.items():
    m = _STACKED.match(name)
    if m is None:
      out[name] = leaf
      continue
    for i in range(leaf.shape[0]):
      out[_join(m.group(1), f"blocks_{i:02d}/{m.group(2)}")] = leaf[i]
  return _same_form(params, out)


def to_layout(params, names) -> dict:
  """The slash-flat tree `params` in the layout of the names `names`
  (stacked if any of them is a `blocks/` name, else unrolled)."""
  flat = _flat(params)
  stacked = any(_STACKED.match(n) for n in names)
  return _flat(stack_blocks(flat) if stacked else unstack_blocks(flat))


def _flax_leaf(name: str, ndim: int) -> tuple:
  """(flax slash name, whether it is an OIHW conv `weight`, flax's HWIO
  `kernel`) of a state_dict entry of `ndim` dimensions."""
  flax_name = name.replace(".", "/")
  if ndim == 4 and flax_name.endswith("/weight"):
    return flax_name[:-len("weight")] + "kernel", True
  return flax_name, False


def _as_tensor(leaf) -> torch.Tensor:
  if isinstance(leaf, torch.Tensor):
    return leaf
  a = np.array(leaf)  # an owned, writable copy
  if a.dtype.name == "bfloat16":  # ml_dtypes' bf16, as JAX hands it over
    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
  return torch.from_numpy(a)


def params_from_jax(params, model: torch.nn.Module) -> dict:
  """state_dict for `model` from a flax-named tree (nested or `a/b/c`-flat)
  of numpy arrays or tensors, in either block layout (see
  `stack_blocks`). Raises KeyError on a leftover or missing name and
  ValueError on a shape mismatch."""
  want = model.state_dict()
  leaves = {k: _flax_leaf(k, v.ndim) for k, v in want.items()}
  got = to_layout(params, [f for f, _ in leaves.values()])
  missing = sorted(k for k, (f, _) in leaves.items() if f not in got)
  leftover = sorted(set(got) - {f for f, _ in leaves.values()})
  if missing or leftover:
    raise KeyError(f"param names differ from the model's: missing "
                   f"{missing[:8]}{'...' if len(missing) > 8 else ''}, "
                   f"left over {leftover[:8]}"
                   f"{'...' if len(leftover) > 8 else ''}")
  out = {}
  for name, ref in want.items():
    flax_name, conv = leaves[name]
    t = _as_tensor(got[flax_name])
    if conv:
      t = t.permute(3, 2, 0, 1).contiguous()
    if tuple(t.shape) != tuple(ref.shape):
      raise ValueError(f"{name}: shape {tuple(t.shape)} != model's "
                       f"{tuple(ref.shape)}")
    out[name] = t
  return out


def params_to_jax(state_dict, stacked: Optional[bool] = None) -> dict:
  """Nested flax-named tree of float32 numpy arrays from a state_dict, in
  its block layout, or stacked (`stacked=True`) or unrolled (False)."""
  names, values = [], []
  for k, v in state_dict.items():
    flax_name, conv = _flax_leaf(k, v.ndim)
    a = v.detach().float().cpu().numpy()
    names.append(flax_name)
    values.append(np.ascontiguousarray(a.transpose(2, 3, 1, 0)) if conv
                  else a)
  tree = recover_tree(names, values)
  if stacked is None:
    return tree
  return stack_blocks(tree) if stacked else unstack_blocks(tree)


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
  return 1.0, 0.0  # cls, mask_token, probe, label embedding table


def _unrolled_shapes(config: dict) -> dict:
  """{flax name: shape} of the config's model in the unrolled layout."""
  from small_vision_tpu_torch.train.train_ae import build_model
  config = dict(config, model={**config.get("model", {}), "scan": False})
  shapes = {}
  for k, v in build_model(config, device="meta").state_dict().items():
    flax_name, conv = _flax_leaf(k, v.ndim)
    shapes[flax_name] = tuple(v.shape[i] for i in (2, 3, 1, 0)) if conv else (
        tuple(v.shape))
  return shapes


def _in_config_layout(config: dict, tree):
  if config.get("model", {}).get("scan", False):
    return stack_blocks(tree)
  return tree


def init_params(config: dict, seed: int) -> dict:
  """Nested flax-named tree of float32 numpy arrays for the config's model,
  drawn from `np.random.default_rng(seed)` in the sorted-name order of the
  unrolled layout, then stacked where the config's model has `scan`: the
  two layouts of one seed hold the same weights."""
  shapes = _unrolled_shapes(config)
  names = sorted(shapes)
  rng = np.random.default_rng(seed)
  values = []
  for name in names:
    std, mean = _std_and_mean(name, shapes[name])
    a = rng.standard_normal(shapes[name], dtype=np.float32)
    values.append(a * np.float32(std) + np.float32(mean))
  return _in_config_layout(config, recover_tree(names, values))


def _train_init(name: str, shape, rng) -> np.ndarray:
  """One leaf as the JAX module initialises it (models/ae.py, vit.py,
  embeddings.py and flax's defaults)."""
  parts = name.split("/")
  leaf, parent = parts[-1], (parts[-2] if len(parts) > 1 else "")
  grand = parts[-3] if len(parts) > 2 else ""
  normal = lambda std: rng.standard_normal(shape) * std
  zeros = lambda: np.zeros(shape)

  xavier = lambda fan_in, fan_out: np_xavier_uniform(rng, shape, fan_in,
                                                     fan_out)
  lecun = lambda fan_in: np_lecun_normal(rng, shape, fan_in)

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
  from, drawn from `np.random.default_rng(seed)` in the sorted-name order
  of the unrolled layout, then stacked where the config's model has
  `scan`. Where the model's module has `init_leaf(name, shape, rng,
  model_config)` and it gives a leaf (not None), that leaf is its."""
  shapes = _unrolled_shapes(config)
  names = sorted(shapes)
  rng = np.random.default_rng(seed)
  own = getattr(models.get_model_module(config.get("model_name", "ae")),
                "init_leaf", None)
  model_config = config.get("model", {})
  values = []
  for n in names:
    a = None if own is None else own(n, shapes[n], rng, model_config)
    if a is None:
      a = _train_init(n, shapes[n], rng)
    values.append(a.astype(np.float32))
  return _in_config_layout(config, recover_tree(names, values))


def opt_state_from_jax(names, *, count, mu, nu, ema_params=None,
                       device="cpu"):
  """(AdamW state, EMA list or None) for the parameters `names` (flax
  names, in the port's order) from a JAX run's ScaleByAdamState fields
  and EMA params, given as nested or flat flax-named numpy trees in either
  block layout (mu and nu are keyed as the parameters)."""
  def as_list(tree, dtype):
    flat = to_layout(tree, names)
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
  flat = to_layout(state["params"], names)
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


# How an InceptionV3 leaf's layout differs between the two: a convolution
# kernel is OIHW here and HWIO in flax, the head's kernel transposed.
_TO_FLAX = {"conv": lambda a: a.transpose(2, 3, 1, 0), "dense": np.transpose,
            None: lambda a: a}
_FROM_FLAX = {"conv": lambda a: a.transpose(3, 2, 0, 1), "dense": np.transpose,
              None: lambda a: a}


def _inception_leaf(name: str):
  """(flax slash name, layout kind) of an InceptionV3 state_dict entry."""
  path, leaf = name.rsplit(".", 1)
  flax_path = path.replace(".", "/")
  if path == "fc":
    return f"params/fc/{'kernel' if leaf == 'weight' else 'bias'}", (
        "dense" if leaf == "weight" else None)
  if leaf == "weight":
    return f"params/{flax_path}/kernel", "conv"
  col = "batch_stats" if leaf in ("mean", "var") else "params"
  return f"{col}/{flax_path}/{leaf}", None


def inception_state_dict(variables, model: torch.nn.Module) -> dict:
  """state_dict for the port's InceptionV3 from flax variables (nested)
  or a slash-keyed flat mapping. Raises KeyError on a leftover or missing
  name and ValueError on a shape mismatch."""
  got = _flat(variables)
  want = {name: _inception_leaf(name) for name in model.state_dict()}
  flax_names = {f for f, _ in want.values()}
  missing, leftover = sorted(flax_names - set(got)), sorted(set(got) -
                                                           flax_names)
  if missing or leftover:
    raise KeyError(f"InceptionV3 names differ: missing {missing[:8]}, left "
                   f"over {leftover[:8]}")
  out = {}
  for name, ref in model.state_dict().items():
    flax_name, kind = want[name]
    a = _FROM_FLAX[kind](np.asarray(got[flax_name], np.float32))
    if a.shape != tuple(ref.shape):
      raise ValueError(f"{flax_name}: shape {a.shape} does not fit {name} "
                       f"{tuple(ref.shape)}")
    out[name] = torch.from_numpy(np.ascontiguousarray(a))
  return out


def inception_to_jax(state_dict) -> dict:
  """Nested flax variables {"params", "batch_stats"} of float32 numpy
  arrays from the port's InceptionV3 state_dict."""
  names, values = [], []
  for name, t in state_dict.items():
    flax_name, kind = _inception_leaf(name)
    names.append(flax_name)
    values.append(np.ascontiguousarray(
        _TO_FLAX[kind](t.detach().float().cpu().numpy())))
  return recover_tree(names, values)


def _vae_leaf(name: str, ndim: int):
  """(flax slash name, layout kind) of an AutoencoderKL state_dict entry of
  `ndim` dimensions: a Conv2d weight (4-D) is flax's HWIO `kernel`, a
  Linear weight (2-D) the (in, out) Dense `kernel`, a GroupNorm weight
  (1-D) its `scale`."""
  path, leaf = name.rsplit(".", 1)
  flax_path = path.replace(".", "/")
  if leaf == "bias":
    return f"{flax_path}/bias", None
  kind = {4: "conv", 2: "dense", 1: None}[ndim]
  return f"{flax_path}/{'scale' if ndim == 1 else 'kernel'}", kind


def vae_state_dict(flax_tree_or_npz, model: torch.nn.Module) -> dict:
  """state_dict for the port's `models.vae.AutoencoderKL` from the flax
  params (nested or slash-flat) or the path of the npz that
  `scripts/convert_vae.py` writes (keys `params/encoder/conv_in/kernel`,
  ...; the leading `params` level is taken off). Raises KeyError on a
  leftover or missing name and ValueError on a shape mismatch."""
  if isinstance(flax_tree_or_npz, (str, bytes)) or hasattr(
      flax_tree_or_npz, "__fspath__"):
    with np.load(flax_tree_or_npz) as data:
      keys, values = zip(*data.items())
    flax_tree_or_npz = recover_tree(keys, values)
  got = _flat(flax_tree_or_npz)
  if got and all(k.startswith("params/") for k in got):
    got = {k[len("params/"):]: v for k, v in got.items()}
  ref = model.state_dict()
  want = {name: _vae_leaf(name, t.ndim) for name, t in ref.items()}
  flax_names = {f for f, _ in want.values()}
  missing, leftover = sorted(flax_names - set(got)), sorted(set(got) -
                                                           flax_names)
  if missing or leftover:
    raise KeyError(f"VAE names differ: missing {missing[:8]}, left over "
                   f"{leftover[:8]}")
  out = {}
  for name, t in ref.items():
    flax_name, kind = want[name]
    a = _FROM_FLAX[kind](np.array(got[flax_name], np.float32))
    if a.shape != tuple(t.shape):
      raise ValueError(f"{flax_name}: shape {a.shape} does not fit {name} "
                       f"{tuple(t.shape)}")
    out[name] = torch.from_numpy(np.ascontiguousarray(a))
  return out


def vae_to_jax(state_dict) -> dict:
  """Nested flax params of float32 numpy arrays from the port's
  AutoencoderKL state_dict (its inverse)."""
  names, values = [], []
  for name, t in state_dict.items():
    flax_name, kind = _vae_leaf(name, t.ndim)
    names.append(flax_name)
    values.append(np.ascontiguousarray(
        _TO_FLAX[kind](t.detach().float().cpu().numpy())))
  return recover_tree(names, values)
