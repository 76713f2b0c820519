"""GPipe pipeline parallelism over the mesh's `pipe` axis.

Counterpart of small_vision_tpu/parallel/pipeline.py. The depth of a
stacked (`scan=True`) block stack is cut into S contiguous stages, each
process on the `pipe` axis holds its stage's layers only (the `pipeline`
sharding strategy: dim 0 of every `blocks/` leaf over `pipe`), and the
activations move stage to stage with a `ppermute`, on JAX's schedule:

  tick t (of M + S - 1):   stage s computes microbatch m = t - s (clamped:
                           a tick outside 0 <= m < M computes on a clamped
                           microbatch, and nothing reads its result)
  after each tick:         one ppermute shifts the activations s -> s + 1

Stage 0 takes microbatch t of the input; the others take what the
ppermute brought (`torch.where` on the stage index, so that every rank's
graph holds every ppermute). Conditioning aligned with the batch (AdaLN's
cond) rides along as `aux`, microbatched like x: stage s reads aux[t - s].
The last stage's outputs are summed over `pipe`, so every stage holds the
result.

The backward is autograd through the differentiable collectives: each
`ppermute`'s backward is the reverse permutation, the sum's passes its
gradient through (every stage continues with the same result), and the
input's gradient is summed over `pipe` (only stage 0 reads x, and each
stage's layers read aux). Every rank runs the same tick sequence, so the
backward's collectives meet in the same order: the ppermutes in reverse
tick order, then the one all-reduce of the inputs' gradients.

Each process passes its own shard: `pipeline_apply` takes the rank's
block of `stage_params`' output (leaves [1, layers/S, ...]),
`pipeline_apply_stacked` the rank's block of the stack itself (leaves
[layers/S, ...]), as JAX's `shard_map` hands each device its block. `x`
is the process's rows of the batch (its data-parallel group pipelines
them); M must divide them.
"""

import torch

from small_vision_tpu_torch.parallel import collectives
from small_vision_tpu_torch.utils.trees import tree_leaves, tree_map


def stage_params(stacked_params, n_stages):
  """[num_layers, ...] leaves -> [n_stages, layers_per_stage, ...]."""
  def split(x):
    assert x.shape[0] % n_stages == 0, (
        f"num_layers {x.shape[0]} not divisible by {n_stages} stages")
    return x.reshape((n_stages, x.shape[0] // n_stages) + tuple(x.shape[1:]))
  return tree_map(split, stacked_params)


def unstage_params(staged_params):
  """Inverse of `stage_params`."""
  return tree_map(lambda x: x.reshape((x.shape[0] * x.shape[1],)
                                  + tuple(x.shape[2:])), staged_params)


def staged_param_specs(staged_params, axis="pipe"):
  """The spec of every leaf: its stage dim (0) over `axis`."""
  return tree_map(lambda x: (axis,) + (None,) * (len(x.shape) - 1),
                  staged_params)


def bubble_fraction(n_stages, n_microbatches):
  """The GPipe idle fraction (S-1)/(M+S-1)."""
  return (n_stages - 1) / (n_microbatches + n_stages - 1)


def _layer(params, i):
  return tree_map(lambda x: x[i], params)


def _pipeline_local(block_fn, params_local, x, aux, *, group,
                    n_microbatches):
  """This rank's GPipe schedule; `params_local` leaves [layers/S, ...]."""
  n_stages = collectives.group_size(group)
  s = collectives.group_rank(group)
  n_layers = tree_leaves(params_local)[0].shape[0]
  m_count = n_microbatches
  aux_leaves = [] if aux is None else tree_leaves(aux)
  entered = collectives.identity_grad_sum(group, x, *aux_leaves)
  x, aux_leaves = entered[0], list(entered[1:])
  assert x.shape[0] % m_count == 0, (tuple(x.shape), m_count)
  for leaf in aux_leaves:
    assert leaf.shape[0] == x.shape[0], (
        f"aux leaves must be batch-aligned: {tuple(leaf.shape)} vs "
        f"{tuple(x.shape)}")
  x_mb = x.chunk(m_count)
  aux_mb = [a.chunk(m_count) for a in aux_leaves]
  first = torch.tensor(s == 0, device=x.device)

  def stage_fn(h, m):
    aux_here = None
    if aux is not None:
      it = iter([a[m] for a in aux_mb])
      aux_here = tree_map(lambda _: next(it), aux)
    for i in range(n_layers):
      lp = _layer(params_local, i)
      h = block_fn(lp, h) if aux is None else block_fn(lp, h, aux_here)
    return h

  state = torch.zeros_like(x_mb[0])
  outs = []
  n_ticks = m_count + n_stages - 1
  for t in range(n_ticks):
    m_here = min(max(t - s, 0), m_count - 1)
    h_in = torch.where(first, x_mb[min(t, m_count - 1)], state)
    h_out = stage_fn(h_in, m_here)
    if t >= n_stages - 1:  # the last stage finishes microbatch t - (S-1)
      outs.append(h_out)
    if t < n_ticks - 1:
      state = collectives.ppermute_grad(h_out, group, 1)
  # Only the last stage holds the result; every stage's outputs stay in its
  # graph (as zeros elsewhere), so that each rank's backward runs every
  # tick and meets the others in each ppermute.
  last = torch.tensor(s == n_stages - 1, device=x.device)
  out = torch.where(last, torch.cat(outs), torch.zeros_like(x))
  return collectives.sum_grad_identity(out, group)


def pipeline_apply(block_fn, staged_params, x, *, mesh, axis="pipe",
                   n_microbatches, batch_axes=(), aux=None):
  """Applies the stack's layers to x, pipelined over the mesh axis `axis`.

  Args:
    block_fn: (layer_params, x[, aux]) -> x for ONE layer (the aux
      argument is passed iff `aux` is given).
    staged_params: this process's block of `stage_params`' output, leaves
      [1, layers/S, ...] (`sharding.reshard(staged, staged_param_specs(
      staged), mesh)`).
    x: this process's rows [B, ...], the same on every stage of its group.
    mesh: the process mesh (with `axis`).
    n_microbatches: M; it must divide B.
    batch_axes: the axes x's rows are split over (each data-parallel group
      pipelines its own rows; kept for JAX's signature).
    aux: optional tree of batch-aligned ([B, ...]) conditioning tensors,
      delivered per microbatch to block_fn.

  Returns x after every layer, on every stage. Differentiable: the
  gradients of the staged parameters are this stage's, those of x and aux
  the whole stack's.
  """
  del batch_axes
  return _pipeline_local(block_fn, tree_map(lambda p: p[0], staged_params),
                         x, aux, group=mesh.group(axis),
                         n_microbatches=n_microbatches)


def pipeline_apply_stacked(block_fn, stacked_params, x, *, mesh, axis="pipe",
                           n_microbatches, batch_axes=(), aux=None):
  """`pipeline_apply` on this process's block of the raw stack: leaves
  [layers/S, ...], the `pipeline` strategy's shard of a [num_layers, ...]
  stack (no re-staging, so a `scan=True` model pipes its parameters in
  unchanged)."""
  del batch_axes
  return _pipeline_local(block_fn, stacked_params, x, aux,
                         group=mesh.group(axis),
                         n_microbatches=n_microbatches)
