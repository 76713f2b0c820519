"""Collectives: the transport of the sharded step and the pipeline, and the
host-level helpers of the evaluators and the train loop.

Counterpart of small_vision_tpu/parallel/collectives.py (`process_allgather`,
`fetch_global`, `broadcast_one_to_all`, `gather_metrics`, each with the
single-process fast path) and of the `lax` collectives that JAX's
`explicit_step.py` and `pipeline.py` write inside `shard_map`:

  all_reduce, all_gather, reduce_scatter, broadcast, ppermute
      on a process group, tiled along a dim as `lax.all_gather(...,
      tiled=True)` and `lax.psum_scatter(..., tiled=True)`;
  gather, scatter, ppermute_grad, sum_grad_identity, identity_grad_sum
      differentiable versions (`torch.autograd.Function`): the backward of
      a gather is a reduce-scatter, of a scatter a gather, of a ppermute
      the reverse permutation; `sum_grad_identity` sums over the group and
      passes the gradient through (the output of a computation every rank
      then continues identically), `identity_grad_sum` the reverse (its
      input).

A group of None holds one process: every function returns its input (the
fast path, no copy where none is needed), so one process pays nothing for
the layer. On a gloo group, a CUDA tensor goes through host memory for the
collectives that gloo runs on CPU tensors only (`GLOO_HOST_STAGED`); that
is chosen by the group's backend, never by catching an error. NCCL takes
every collective on the card.

The host-level helpers take `group="world"` (every process) by default; a
group of None there is one process (nothing to reduce).
"""

import numpy as np
import torch

from small_vision_tpu_torch.utils.trees import tree_map

# Collectives that gloo runs on CPU tensors only: a CUDA tensor is copied to
# the host, sent there and copied back. In torch 2.11 gloo takes CUDA
# tensors in all_reduce, broadcast, all_gather_into_tensor and
# reduce_scatter_tensor, and aborts the process on a CUDA tensor in
# send/recv (`tools/dryrun_multichip.py --probe` checks each one's values
# on the card).
GLOO_HOST_STAGED = frozenset({"ppermute"})


def _dist():
  import torch.distributed as dist
  return dist


def group_size(group) -> int:
  return 1 if group is None else _dist().get_world_size(group)


def group_rank(group) -> int:
  return 0 if group is None else _dist().get_rank(group)


def _staged(name: str, group, t: torch.Tensor) -> bool:
  return (t.is_cuda and name in GLOO_HOST_STAGED
          and _dist().get_backend(group) == "gloo")


def transport(group) -> str:
  """How a CUDA tensor travels on `group`: "local" (one process), "nccl",
  or "gloo, host-staged: ..." naming the collectives staged through host
  memory."""
  if group is None:
    return "local"
  backend = _dist().get_backend(group)
  if backend == "gloo":
    return "gloo, host-staged: " + ", ".join(sorted(GLOO_HOST_STAGED))
  return backend


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
  """The sum (or "mean", "max") of `t` over the group; in place, returned."""
  n = group_size(group)
  if n == 1:
    return t
  dist = _dist()
  reduce_op = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
  if _staged("all_reduce", group, t):
    host = t.cpu()
    dist.all_reduce(host, reduce_op, group=group)
    t.copy_(host)
  else:
    dist.all_reduce(t, reduce_op, group=group)
  if op == "mean":
    t.div_(n)
  return t


def broadcast(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
  """Group rank `src`'s `t` on every rank, in place."""
  if group_size(group) == 1:
    return t
  dist = _dist()
  root = dist.get_global_rank(group, src)
  if _staged("broadcast", group, t):
    host = t.cpu()
    dist.broadcast(host, root, group=group)
    t.copy_(host)
  else:
    dist.broadcast(t, root, group=group)
  return t


def _gather0(out, x, group):
  dist = _dist()
  fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
  fn(out, x, group=group)


def _scatter0(out, x, group):
  dist = _dist()
  fn = (getattr(dist, "reduce_scatter_single", None)
        or dist.reduce_scatter_tensor)
  fn(out, x, group=group)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
  """The ranks' `x` concatenated along `dim`, in group-rank order (a
  contiguous tensor: the kernels take their vectors so)."""
  n = group_size(group)
  if n == 1:
    return x
  moved = x.movedim(dim, 0).contiguous()
  staged = _staged("all_gather", group, x)
  src = moved.cpu() if staged else moved
  out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                    dtype=src.dtype, device=src.device)
  _gather0(out, src, group)
  if staged:
    out = out.to(x.device)
  return out.movedim(0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
  """This rank's chunk along `dim` of the sum of the ranks' `x`."""
  n = group_size(group)
  if n == 1:
    return x
  moved = x.movedim(dim, 0).contiguous()
  assert moved.shape[0] % n == 0, (tuple(x.shape), dim, n)
  staged = _staged("reduce_scatter", group, x)
  src = moved.cpu() if staged else moved
  out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                    dtype=src.dtype, device=src.device)
  _scatter0(out, src, group)
  if staged:
    out = out.to(x.device)
  return out.movedim(0, dim).contiguous()


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
  """Rank r's `x` arrives at rank (r + shift) mod n (`lax.ppermute` with
  the permutation [(i, (i + shift) % n)])."""
  n = group_size(group)
  if n == 1:
    return x
  dist = _dist()
  r = dist.get_rank(group)
  dst = dist.get_global_rank(group, (r + shift) % n)
  src = dist.get_global_rank(group, (r - shift) % n)
  staged = _staged("ppermute", group, x)
  send = x.detach().contiguous()
  send = send.cpu() if staged else send
  recv = torch.empty_like(send)
  for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst, group),
                                      dist.P2POp(dist.irecv, recv, src, group)]):
    work.wait()
  return recv.to(x.device) if staged else recv


class _Gather(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, group, dim):
    ctx.group, ctx.dim = group, dim
    return all_gather(x, group, dim)

  @staticmethod
  def backward(ctx, g):
    return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _Scatter(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, group, dim):
    ctx.group, ctx.dim = group, dim
    n = group_size(group)
    return x.chunk(n, dim)[group_rank(group)].contiguous()

  @staticmethod
  def backward(ctx, g):
    return all_gather(g.contiguous(), ctx.group, ctx.dim), None, None


class _PPermute(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, group, shift):
    ctx.group, ctx.shift = group, shift
    return ppermute(x, group, shift)

  @staticmethod
  def backward(ctx, g):
    return ppermute(g, ctx.group, -ctx.shift), None, None


class _SumGradIdentity(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, group):
    return all_reduce(x.clone(), group)

  @staticmethod
  def backward(ctx, g):
    return g, None


class _IdentityGradSum(torch.autograd.Function):

  @staticmethod
  def forward(ctx, group, *xs):
    ctx.group = group
    return tuple(x.view_as(x) for x in xs)

  @staticmethod
  def backward(ctx, *gs):
    # One collective for all the inputs, so that the ranks' backward passes
    # meet in one all-reduce whatever order autograd takes.
    flat = torch.cat([g.reshape(-1).float() for g in gs])
    all_reduce(flat, ctx.group)
    out, i = [], 0
    for g in gs:
      out.append(flat[i:i + g.numel()].view(g.shape).to(g.dtype))
      i += g.numel()
    return (None, *out)


def gather(x, group, dim: int = 0):
  """Differentiable tiled all-gather; its backward reduce-scatters (sums)."""
  return x if group_size(group) == 1 else _Gather.apply(x, group, dim)


def scatter(x, group, dim: int = 0):
  """Differentiable: this rank's chunk of `x` along `dim`; its backward
  all-gathers."""
  return x if group_size(group) == 1 else _Scatter.apply(x, group, dim)


def ppermute_grad(x, group, shift: int = 1):
  """Differentiable `ppermute`; its backward is the reverse permutation."""
  return x if group_size(group) == 1 else _PPermute.apply(x, group, shift)


def sum_grad_identity(x, group):
  """The sum over the group; the gradient passes through unchanged."""
  return x if group_size(group) == 1 else _SumGradIdentity.apply(x, group)


def identity_grad_sum(group, *xs):
  """The inputs unchanged; their gradients are summed over the group (one
  all-reduce for all of them)."""
  if group_size(group) == 1:
    return xs
  return _IdentityGradSum.apply(group, *xs)


# The host-level helpers: numpy in, numpy out, on the world (or a group).


WORLD = "world"


def _resolve(group):
  """The process group a host helper works on: "world" is every process
  (None with one), else the group given (None: this process alone)."""
  if group != WORLD:
    return group
  from small_vision_tpu_torch.parallel import mesh as mesh_lib
  return _dist().group.WORLD if mesh_lib.process_count() > 1 else None


def _group_device(group):
  if _dist().get_backend(group) == "nccl":
    return torch.device("cuda", torch.cuda.current_device())
  return torch.device("cpu")


def _to_numpy(x):
  if isinstance(x, torch.Tensor):
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
      x = x.float()
    return x.numpy()
  return np.asarray(x)


def process_allgather(tree, tiled: bool = True, group=WORLD):
  """Every process's values, on every process: concatenated on axis 0
  (`tiled`) or stacked on a new axis 0. The arrays must have one shape on
  every process. One process: the values as numpy."""
  group = _resolve(group)

  def one(x):
    x = _to_numpy(x)
    if group is None:
      return x if tiled else x[None]
    t = torch.from_numpy(np.ascontiguousarray(x)).to(_group_device(group))
    out = all_gather(t.reshape((1,) + tuple(t.shape)), group, 0).cpu().numpy()
    return out.reshape((-1,) + x.shape[1:]) if tiled else out
  return tree_map(one, tree)


def fetch_global(tree, group=WORLD):
  """Host numpy of values whose rows (dim 0) are split over the processes
  of `group` (default: every process): each process's rows, gathered in
  process order (as JAX's `fetch_global` reassembles a batch-sharded
  array). None stays None."""
  return tree_map(lambda x: None if x is None else process_allgather(
      x, True, group), tree)


def broadcast_one_to_all(tree, group=WORLD):
  """Process 0's values on every process (numpy)."""
  group = _resolve(group)
  if group is None:
    return tree

  def one(x):
    arr = _to_numpy(x)
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(_group_device(group))
    return broadcast(t, group, 0).cpu().numpy()
  return tree_map(one, tree)


def gather_metrics(value):
  """A metric as host numpy (a float for a scalar); a per-process array is
  gathered so that every process logs the same values."""
  if np.isscalar(value) or (hasattr(value, "ndim") and value.ndim == 0):
    return float(value)
  gathered = process_allgather(value)
  return (gathered.reshape(-1, *gathered.shape[2:]) if gathered.ndim > 1
          else gathered)


def all_reduce_host(values, group=WORLD, op: str = "sum") -> np.ndarray:
  """The sum (or mean, max) of a float64 vector over `group` (default:
  every process), as numpy; one process: the values."""
  arr = np.asarray(values, np.float64)
  group = _resolve(group)
  if group is None:
    return arr
  t = torch.from_numpy(arr.copy()).to(_group_device(group))
  return all_reduce(t, group, op).cpu().numpy()
