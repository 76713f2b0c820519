"""A training step with its collectives written out: data parallel (dp) and
ZeRO-3 (zero3).

Counterpart of small_vision_tpu/parallel/explicit_step.py, whose
`shard_map` step this is, process by process:

  dp:     parameters and optimizer state replicated; each process's
          gradients -> mean over the batch axes (one all-reduce); the same
          update on every process.
  zero3:  parameters and optimizer state sharded by
          `infer_sharding(..., "fully_sharded")`; each parameter leaf is
          all-gathered along its shard dim over `fsdp` before the forward,
          its gradient reduce-scattered back (and averaged over `data`),
          and the optimizer updates the local shards only.

The loss is the unmasked diffusion branch (the eps and x0 MSE of the UMD
loss at mask 0 and no_noise_prob 0) with t and the noise passed in, as in
JAX, so the step is deterministic.

ZeRO-3 and the optimizer: the port's AdamW updates whatever tensors it is
given, element by element, except for the clip, which needs the global
norm of the gradients. The step passes the optimizer a norm function that
sums the sharded leaves' squares over `fsdp` and counts the replicated
ones once (`ShardedParams.norm`), and `grad_clip_norm` as its threshold
(None: no clip), so the clip is the one of the whole gradient, as the JAX
step's psum'd norm is.
"""

import torch

from small_vision_tpu_torch.ops import diffusion as gd_lib
from small_vision_tpu_torch.parallel import collectives
from small_vision_tpu_torch.parallel.sharding import (ShardedParams,
                                                      infer_sharding)


def _diffusion_loss(model, gd, images, t, noise, channels):
  """The unmasked diffusion-branch loss with injected (t, noise)."""
  x_t = gd_lib.q_sample(gd, images, t, noise)
  pred, _ = model(x_t, t=t + 1)
  pred_x0, pred_eps = pred[..., :channels], pred[..., channels:]
  return (torch.mean((pred_eps - noise) ** 2)
          + torch.mean((pred_x0 - images) ** 2)) / 2


def make_explicit_update_fn(model, opt, mesh, *, strategy="dp", channels=3,
                            min_size_to_shard=2**18, grad_clip_norm=None):
  """Builds the step on `mesh`: `update(train_state, batch) ->
  (train_state, loss)`.

  `train_state` = {"params", "opt", "gd"}: the parameters as this process
  holds them (`update.place(gd)` builds it from the model's full
  parameters: for zero3 the shards, which the model's parameters then give
  up; `update.layout` is their `ShardedParams`), the optimizer's state over
  them (`opt.init`), and the diffusion tables.
  `batch` = {"image", "t", "noise"}: this process's rows of the global
  batch. `loss` is the mean over the processes.
  """
  if strategy not in ("dp", "zero3"):
    raise ValueError(f"strategy {strategy!r}: dp or zero3")
  if strategy == "zero3":
    assert "fsdp" in mesh.axis_names, "zero3 needs an 'fsdp' mesh axis"
  named = sorted((n.replace(".", "/"), p) for n, p in model.named_parameters())
  names = [n for n, _ in named]
  if strategy == "zero3":
    specs = infer_sharding(dict(named), mesh, "fully_sharded",
                           min_size_to_shard=min_size_to_shard)
  else:
    specs = infer_sharding(dict(named), mesh, "replicated")
  layout = ShardedParams(names, [p for _, p in named],
                         [specs[n] for n in names], mesh)
  group = mesh.batch_group()

  def place(gd):
    params = layout.shard_state()
    return {"params": params, "opt": opt.init(params), "gd": gd}

  def update(train_state, batch):
    layout.gather(train_state["params"])
    loss = _diffusion_loss(model, train_state["gd"], batch["image"],
                           batch["t"].long(), batch["noise"], channels)
    # An unused leaf (the mask token at mask 0) gets zeros, as in JAX.
    grads = torch.autograd.grad(loss, layout.params, allow_unused=True,
                                materialize_grads=True)
    grads = layout.reduce_grads(grads)
    layout.release()
    loss = collectives.all_reduce(loss.detach(), group, "mean")
    with torch.no_grad():
      opt.step(train_state["params"], grads, train_state["opt"],
               norm=layout.norm, clip_norm=grad_clip_norm)
    return train_state, loss

  update.place = place
  update.layout = layout
  return update
