"""Sharding strategies over parameter trees, and moving a tree between its
full and its sharded form.

Counterpart of small_vision_tpu/parallel/sharding.py. A placement is a
spec tuple in the manner of JAX's PartitionSpec: `()` is replicated, and
`(None, "fsdp")` shards dim 1 over the mesh axis `fsdp`. `infer_sharding`
returns a tree of specs shaped like its input (nested dicts, or a flat
{slash name: tensor} dict as the trainer keeps its parameters), by JAX's
rules:

  replicated       every leaf replicated;
  fully_sharded    a leaf of more than `min_size_to_shard` (2^18) elements
                   sharded on its largest evenly divisible dim over `fsdp`,
                   else over `data` (ZeRO-3);
  tensor_parallel  `_TP_RULES`: the q, k, v and out-projections on their
                   heads and the MLP on its hidden dim, over `tensor` (each
                   process then runs Megatron's block of `models.vit` on
                   its block of them; the biases stay replicated);
  tp_fsdp          the TP rules, and `fully_sharded` over `fsdp` for the
                   leaves they do not match;
  pipeline         `blocks/` stacks (the `scan=True` layout) on dim 0 over
                   `pipe`, the rest replicated.

The port keeps flax's layouts (`Dense` kernels (in, out), DenseGeneral's
(d, H, hd)), so each leaf's spec, and each process's element count, is the
JAX package's. `reshard` takes a full tensor to this process's shard and
`unshard` gathers it back (an all-gather over the spec's axis); the
trainer's sharded step (`train/train_ae.py`) and `explicit_step.py` write
the collectives of a step out with these specs.
"""

import re
from collections.abc import Mapping

import numpy as np

from small_vision_tpu_torch.parallel import collectives
from small_vision_tpu_torch.utils.trees import (recover_tree,
                                                tree_flatten_with_names)

REPLICATED = ()


def _shape(x) -> tuple:
  return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def _is_flat(tree) -> bool:
  return isinstance(tree, Mapping) and not any(
      isinstance(v, Mapping) for v in tree.values())


def tree_map_with_names(fn, tree):
  """`fn(name, leaf)` over a nested or a flat {name: leaf} dict, the result
  shaped like `tree`."""
  pairs = tree_flatten_with_names(tree)
  out = [fn(n, v) for n, v in pairs]
  if _is_flat(tree):
    return dict(zip([n for n, _ in pairs], out))
  return recover_tree([n for n, _ in pairs], out)


def _shard_dim(dim: int, ndim: int, axis: str) -> tuple:
  spec = [None] * ndim
  spec[dim] = axis
  return tuple(spec)


def infer_sharding(tree, mesh, strategy: str = "replicated",
                   axis_name: str = None, **strategy_args):
  """A tree of spec tuples matching `tree` (leaves need only `.shape`)."""
  fns = {"replicated": replicated, "fully_sharded": fully_sharded,
         "tensor_parallel": tensor_parallel, "tp_fsdp": tp_fsdp,
         "pipeline": pipeline}
  if strategy not in fns:
    raise ValueError(f"Unknown sharding strategy: {strategy!r}")
  return fns[strategy](tree, mesh, axis_name=axis_name, **strategy_args)


def replicated(tree, mesh, axis_name=None):
  del mesh, axis_name
  return tree_map_with_names(lambda n, x: REPLICATED, tree)


def fully_sharded(tree, mesh, axis_name=None, min_size_to_shard: int = 2**18):
  """ZeRO-3: every leaf over `min_size_to_shard` elements sharded on its
  largest evenly divisible dim, over `axis_name`, else `fsdp` when the mesh
  has it, else `data`."""
  if axis_name is None:
    axis_name = "fsdp" if "fsdp" in mesh.axis_names else "data"
  size = mesh.shape[axis_name]

  def spec_for(_, x):
    shape = _shape(x)
    if int(np.prod(shape, dtype=np.int64)) <= min_size_to_shard:
      return REPLICATED
    for dim in np.argsort(shape)[::-1]:  # JAX's order, ties included
      if shape[dim] % size == 0:
        return _shard_dim(int(dim), len(shape), axis_name)
    return REPLICATED
  return tree_map_with_names(spec_for, tree)


# The JAX rules on the port's names (the flax ones): the trailing dims of
# each kernel; a stacked (`scan=True`) leaf has a leading depth dim left
# unsharded. Megatron-style: one all-reduce per block half.
_TP_RULES = (
    (r".*/(query|key|value)/kernel", (None, "tensor", None)),
    (r".*/out/kernel", ("tensor", None, None)),
    (r".*Mlp.*/Dense_0/kernel", (None, "tensor")),
    (r".*Mlp.*/Dense_1/kernel", ("tensor", None)),
)


def tensor_parallel(tree, mesh, axis_name=None):
  """Width sharding of the blocks' projections over the `tensor` axis."""
  axis_name = axis_name or "tensor"
  assert axis_name in mesh.axis_names, f"mesh lacks '{axis_name}' axis"

  def spec_for(name, x):
    ndim = len(_shape(x))
    for pattern, dims in _TP_RULES:
      if re.fullmatch(pattern, name):
        return tuple([None] * (ndim - len(dims)) + [
            axis_name if d == "tensor" else None for d in dims])
    return REPLICATED
  return tree_map_with_names(spec_for, tree)


def pipeline(tree, mesh, axis_name=None):
  """`blocks/` stacks on dim 0 over `pipe` (each stage holds its layers);
  everything else replicated."""
  axis_name = axis_name or "pipe"
  assert axis_name in mesh.axis_names, f"mesh lacks '{axis_name}' axis"
  n_stages = mesh.shape[axis_name]

  def spec_for(name, x):
    shape = _shape(x)
    if re.search(r"(^|/)blocks/", name) and shape and \
        shape[0] % n_stages == 0:
      return _shard_dim(0, len(shape), axis_name)
    return REPLICATED
  return tree_map_with_names(spec_for, tree)


def tp_fsdp(tree, mesh, axis_name=None, min_size_to_shard: int = 2**18):
  """The TP rules over `tensor`; every leaf they leave replicated ZeRO-3
  over `fsdp`."""
  del axis_name
  tp = dict(tree_flatten_with_names(tensor_parallel(tree, mesh)))
  fs = dict(tree_flatten_with_names(fully_sharded(
      tree, mesh, axis_name="fsdp", min_size_to_shard=min_size_to_shard)))
  return tree_map_with_names(
      lambda n, _: tp[n] if any(e is not None for e in tp[n]) else fs[n],
      tree)


def spec_axis(spec):
  """(dim, axis) of a spec's one sharded dim, or None when replicated."""
  hits = [(i, e) for i, e in enumerate(spec) if e is not None]
  if not hits:
    return None
  if len(hits) > 1 or not isinstance(hits[0][1], str):
    raise NotImplementedError(f"spec {spec}: one dim over one axis only")
  return hits[0]


def shard_shape(shape, spec, mesh) -> tuple:
  """The shape of one process's shard of a leaf of `shape` under `spec`."""
  shape = list(_shape(shape))
  hit = spec_axis(spec)
  if hit is not None:
    dim, axis = hit
    assert shape[dim] % mesh.shape[axis] == 0, (shape, spec, mesh)
    shape[dim] //= mesh.shape[axis]
  return tuple(shape)


def shard_of(x, spec, mesh, rank=None):
  """Process `rank`'s (default: this one's) shard of the full leaf `x`: a
  view of its block on the sharded dim."""
  hit = spec_axis(spec)
  if hit is None:
    return x
  dim, axis = hit
  return x.chunk(mesh.shape[axis], dim)[mesh.coord(axis, rank)]


def _per_leaf(fn, tree, specs):
  if not isinstance(tree, Mapping):
    return fn(tree, specs)
  if isinstance(specs, tuple):
    specs = tree_map_with_names(lambda n, _: specs, tree)
  flat_specs = dict(tree_flatten_with_names(specs))
  return tree_map_with_names(lambda n, x: fn(x, flat_specs[n]), tree)


def reshard(tree, specs, mesh, rank=None):
  """This process's shards of a tree of full leaves (a spec tuple applies
  to every leaf). JAX places the arrays on their devices; here each process
  keeps its own block."""
  return _per_leaf(lambda x, s: shard_of(x, s, mesh, rank), tree, specs)


def unshard(tree, specs, mesh):
  """The full leaves of a tree of this process's shards: each sharded leaf
  all-gathered along its dim over its axis."""
  def full(x, spec):
    hit = spec_axis(spec)
    if hit is None:
      return x
    dim, axis = hit
    return collectives.all_gather(x, mesh.group(axis), dim)
  return _per_leaf(full, tree, specs)


class ShardedParams:
  """A model's parameters placed by specs on a mesh, the optimizer state
  placed by its own specs, and the collectives of a step on them: what
  `param_sharding` and `optim_sharding` ask of the trainer and `zero3` of
  the explicit step.

  `params` are the model's parameters (full, in the order of `names`,
  `specs` and `opt_specs`; `opt_specs` defaults to `specs`).
  `shard_state()` gives the train state's tensors, this process's part of
  each: a leaf sharded over a batch axis (`fsdp`, or `data` on a 1-D mesh)
  is a separate shard, and the model's parameter is filled by `gather` (an
  all-gather) before a forward and emptied by `release` after the step
  (ZeRO-3); a leaf sharded over `pipe` or `tensor` is the model's
  parameter itself, narrowed to this stage's layers or this tensor rank's
  block (the Megatron block of `models.vit` runs on it, and it is never
  gathered before a forward); a replicated leaf is the model's parameter.

  The optimizer works on `opt_view(params)`: each leaf in the optimizer's
  placement. Where the two placements agree that is the train state's
  tensor. Under a replicated parameter with a sharded optimizer state
  (ZeRO-1) it is a copy of this process's block of the parameter, and
  `commit` all-gathers the updated blocks into the parameter. Under a
  sharded parameter with a replicated optimizer state it is the whole
  parameter (the model's gathered one under ZeRO-3, an all-gather over
  `tensor` of a tensor rank's block), and `commit` keeps this process's
  block of it in the train state; where the two are sharded over
  different axes (`tensor` and `fsdp`) it is the optimizer's block of the
  whole parameter, and `commit` goes through the whole again.
  `reduce_grads` takes the gradients of the model's parameters to the
  mean over the batch in the optimizer's placement: a tensor rank's block
  all-gathered where the optimizer holds more, then a reduce-scatter over
  the shard axis (divided by its size) and a mean over the other batch
  axes, or a mean over the batch axes (one all-reduce for all such
  leaves); never a sum over `tensor`. `norm` is the global norm of a list
  in the optimizer's placement: the squares of the sharded leaves summed
  over their axis, the replicated counted once. `full` and `local` move a
  list of tensors in either placement (`opt=True`: the optimizer's) to
  their full form and back (checkpoints). `vae_specs`: the placement of a
  latent run's frozen VAE (`vae_param_sharding`), None when it is
  replicated.
  """

  def __init__(self, names, params, specs, mesh, opt_specs=None):
    self.names = list(names)
    self.params = list(params)
    self.mesh = mesh
    self.specs = [tuple(s) for s in specs]
    self.opt_specs = (self.specs if opt_specs is None
                      else [tuple(s) for s in opt_specs])
    self.full_shapes = [tuple(p.shape) for p in self.params]
    self.vae_specs = None
    self._axis = [self._real(s) for s in self.specs]
    self._opt_axis = [self._real(s) for s in self.opt_specs]
    for i, (a, o) in enumerate(zip(self._axis, self._opt_axis)):
      if a != o and "pipe" in [h[1] for h in (a, o) if h is not None]:
        raise NotImplementedError(
            f"{self.names[i]}: parameter spec {self.specs[i]} with "
            f"optimizer spec {self.opt_specs[i]}; a stage's optimizer state "
            "follows its layers")
    self._batch = tuple(a for a in ("data", "fsdp")
                        if mesh.axis_size(a) > 1)

  def _real(self, spec):
    """(dim, axis) of a spec sharded over a group of more than one, or
    None."""
    hit = spec_axis(spec)
    return hit if hit and self.mesh.axis_size(hit[1]) > 1 else None

  def _gathered(self, i) -> bool:
    return self._axis[i] is not None and self._axis[i][1] in ("data", "fsdp")

  @property
  def keeps_full_for_update(self) -> bool:
    """Whether the optimizer updates some gathered parameter in full (a
    ZeRO-3 parameter with a replicated optimizer state): the model keeps
    its gathered parameters until `commit`."""
    return any(self._gathered(i) and o is None
               for i, o in enumerate(self._opt_axis))

  def shard_state(self) -> list:
    """The train state's tensors from the model's full parameters."""
    import torch
    out = []
    with torch.no_grad():
      for i, p in enumerate(self.params):
        if self._axis[i] is None:
          out.append(p)
        elif self._gathered(i):
          out.append(shard_of(p.data, self.specs[i], self.mesh).clone(
              memory_format=torch.contiguous_format))
          p.data = p.data.new_empty(0)
        else:  # a stage's layers: the parameter keeps its own block
          p.data = shard_of(p.data, self.specs[i], self.mesh).clone(
              memory_format=torch.contiguous_format)
          out.append(p)
    return out

  def opt_shapes(self) -> list:
    """The shape of each leaf of this process's optimizer state."""
    return [shard_shape(s, spec, self.mesh) if a is not None else s
            for s, spec, a in zip(self.full_shapes, self.opt_specs,
                                  self._opt_axis)]

  def gather(self, shards):
    """Fills the model's ZeRO-3 parameters from the shards (all-gather)."""
    for i, p in enumerate(self.params):
      if self._gathered(i):
        dim, axis = self._axis[i]
        p.data = collectives.all_gather(shards[i].detach(),
                                        self.mesh.group(axis), dim)

  def release(self):
    """Empties the model's ZeRO-3 parameters (until the next `gather`)."""
    for i, p in enumerate(self.params):
      if self._gathered(i):
        p.data = p.data.new_empty(0)

  def _full_param(self, i, t):
    """The whole of parameter `i` from the train state's `t`: the model's
    gathered parameter for a ZeRO-3 leaf, else `t` all-gathered over its
    axis (`tensor`), or `t` itself when replicated."""
    a = self._axis[i]
    if a is None:
      return t
    if self._gathered(i):
      return self.params[i]
    return collectives.all_gather(t.detach(), self.mesh.group(a[1]), a[0])

  def opt_view(self, params) -> list:
    """The tensors the optimizer updates, from the train state's
    `params` (call between `gather` and `release`)."""
    import torch
    out = []
    for i, t in enumerate(params):
      a, o = self._axis[i], self._opt_axis[i]
      if a == o:
        out.append(t)
      elif a is None:  # ZeRO-1: this process's block of the full leaf
        out.append(shard_of(t.data, self.opt_specs[i], self.mesh).clone(
            memory_format=torch.contiguous_format))
      elif o is None:  # the whole parameter, updated in full
        out.append(self._full_param(i, t))
      else:  # the optimizer's block of the whole parameter
        out.append(shard_of(self._full_param(i, t), self.opt_specs[i],
                            self.mesh).clone(
                                memory_format=torch.contiguous_format))
    return out

  def commit(self, params, view):
    """Brings the train state's `params` up to the updated `view`."""
    import torch
    with torch.no_grad():
      for i, t in enumerate(params):
        a, o = self._axis[i], self._opt_axis[i]
        if a == o:
          continue
        full = view[i].data if o is None else collectives.all_gather(
            view[i].detach(), self.mesh.group(o[1]), o[0])
        t.copy_(full if a is None else shard_of(full, self.specs[i],
                                                 self.mesh))

  def reduce_grads(self, grads) -> list:
    """The mean over the batch of each gradient, in the optimizer's
    placement. A gradient of a leaf sharded over `tensor` is this process's
    block of the batch's gradient already (the Megatron block's collectives
    make it so, and make a replicated leaf's the same on every tensor
    rank): it is all-gathered over `tensor` where the optimizer holds the
    leaf otherwise, and never summed over `tensor`."""
    import torch
    out = list(grads)
    buckets = {}  # the batch axes a leaf still needs its mean over
    for i, g in enumerate(grads):
      a, o = self._axis[i], self._opt_axis[i]
      if a is not None and not self._gathered(i) and a != o:
        g = collectives.all_gather(g, self.mesh.group(a[1]), a[0])
      rest = self._batch
      if o is not None and o[1] in ("data", "fsdp"):
        dim, axis = o
        g = collectives.reduce_scatter(g, self.mesh.group(axis), dim)
        g = g / self.mesh.shape[axis]
        rest = tuple(x for x in self._batch if x != axis)
      elif o is not None and a != o:  # a block over `tensor` of the whole
        g = shard_of(g, self.opt_specs[i], self.mesh).contiguous()
      out[i] = g
      if rest:
        buckets.setdefault(rest, []).append(i)
    for axes, idx in buckets.items():
      group = self.mesh.group(*axes)
      flat = torch.cat([out[i].reshape(-1) for i in idx])
      collectives.all_reduce(flat, group, "mean")
      k = 0
      for i in idx:
        n = out[i].numel()
        out[i] = flat[k:k + n].view(out[i].shape)
        k += n
    return out

  def norm(self, tensors):
    """The global norm of a list of tensors in the optimizer's
    placement."""
    import torch
    from small_vision_tpu_torch import optim
    if all(a is None for a in self._opt_axis):
      return optim.global_norm(tensors)
    norms = torch._foreach_norm([t.float() for t in tensors])
    total, by_axis = 0.0, {}
    for i, n in enumerate(norms):
      if self._opt_axis[i] is None:
        total = total + n * n
      else:
        by_axis.setdefault(self._opt_axis[i][1], []).append(n * n)
    for axis, sq in by_axis.items():
      total = total + collectives.all_reduce(torch.stack(sq).sum(),
                                             self.mesh.group(axis))
    return torch.sqrt(total)

  def full(self, tensors, opt: bool = False) -> list:
    """The full form of each of this process's tensors (all-gathers), in
    the parameters' placement or (`opt`) the optimizer's."""
    axes = self._opt_axis if opt else self._axis
    out = []
    for i, t in enumerate(tensors):
      if axes[i] is None:
        out.append(t)
      else:
        dim, axis = axes[i]
        out.append(collectives.all_gather(t.detach(), self.mesh.group(axis),
                                          dim))
    return out

  def model_view(self, tensors) -> list:
    """The tensors as the model's parameters hold them: the ZeRO-3 ones
    gathered, a stage's layers left as they are."""
    return [collectives.all_gather(t.detach(), self.mesh.group(
        self._axis[i][1]), self._axis[i][0]) if self._gathered(i) else t
            for i, t in enumerate(tensors)]

  def local(self, i, full, opt: bool = False):
    """This process's part of leaf `i` from its full form, in the
    parameters' placement or (`opt`) the optimizer's."""
    axis = (self._opt_axis if opt else self._axis)[i]
    spec = (self.opt_specs if opt else self.specs)[i]
    return full if axis is None else shard_of(
        full, spec, self.mesh).contiguous()
