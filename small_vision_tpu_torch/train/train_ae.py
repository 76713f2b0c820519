"""The UMD trainer: the model builder, the training step, a minimal train
loop, and the sampler functions.

Counterpart of small_vision_tpu/train/train_ae.py: `build_model`,
`mae_mix_weight`, `make_update_fn` (the joint MAE + diffusion step: device
pp, q_sample, the two branches, the loss mix, AdamW, EMA), `make_eval_fns`
(predict, noised_predict, patch, loss, and the sampler suite: uncond_eps,
and with `num_classes` cond_eps, cfg_eps_* and cfg_x0_*), and
`train_and_evaluate`: the loop on one card with `Chrono`, the metric
writer, warm start, resumable checkpoints, the finetune surgery, the
evaluators (the sampling evaluators' samples scored by FID and IS where
the config names `inception_reference_path`) and the NaN abort. With
`latent_diffusion` the model works on Stable Diffusion VAE latents: the
step encodes the batch's pixels inside it (unless
`use_preprocessed_latents`), the evaluation functions encode their inputs
and decode what they show, the sampler decodes its samples, and the VAE's
weights ride in the train state and its checkpoints as `vae_params`
(frozen: not in the optimizer, no EMA).

Over several processes (`parallel.mesh`, `launch.py`) the loop runs on a
mesh built from `mesh_fsdp` and `mesh_tensor` (or given), each process on
its own shard of the data and its own rows of the global batch (the
processes that differ only on `tensor` on the same ones), and the
parameters placed by `param_sharding` (`replicated`, `fully_sharded`:
ZeRO-3 over `fsdp`, `tensor_parallel`: the blocks' projections by heads
and hidden units over `tensor`, each process running Megatron's block on
its part (`models.vit`), `tp_fsdp`: those over `tensor` and the rest
ZeRO-3 over `fsdp`, or `pipeline`: the stacks' stages over `pipe`, with
the model's `pipe_stages`; `parallel.sharding.ShardedParams`), the
optimizer state by `optim_sharding` (`replicated` by default, as in JAX,
or any of the others; a pipeline's optimizer state follows its stages),
the EMA as the parameters, and a latent run's frozen VAE by
`vae_param_sharding` (gathered for each encode and decode). A step
gathers the ZeRO-3 parameters, runs the forward and backward on the
process's rows (each process splits its rows between the two branches at
the config's ratio), reduces the gradients to the optimizer's placement
(reduce-scatter and mean over the batch axes, or a mean), and updates
with the clip of the whole gradient's norm: a process's shards in place,
or under ZeRO-1 (replicated parameters, sharded optimizer state) its
block of each parameter, all-gathered after the update, or under sharded
parameters with a replicated optimizer state the whole gathered
parameter, of which it keeps its block.
Such a step is the single-process step on the global batch ordered as
[every process's diffusion rows, then every process's MAE rows]; its
draws are those of that step, each process taking its rows (so a run's
generator state is the same on every process). Process 0 alone writes
metrics, logs, checkpoints (of the gathered, full tensors) and evaluator
outputs; the logged loss is the mean over the batch shards. A pipeline on
a mesh with a `tensor` axis raises: the JAX trainer builds no such mesh.

The step's random draws (t, noise, the two branches' mask noise, the flip
mask, the label-drop masks and the VAE encode's noise) come from the train
state's `torch.Generator`, or are injected, so that a test can drive the
step with the JAX package's draws.

A sampler function is `sample_fn(gd, generator, *, noise=None)`: the model
holds its (EMA) weights, `gd` the diffusion tables, `generator` draws the
noise and labels on the model's device, and `noise` optionally injects the
loop's draws (see `ops.diffusion.ddim_sample_loop`). Given a train state in
place of `gd` (as the sampling evaluator gives it), it takes the state's
tables and runs on its `ema_params` where it has them.

The other evaluation functions are `fn(train_state, batch, generator=None,
*, draws=None)` on a batch that went through the device pp. Their random
draws come from `generator`, by default a copy of the train state's (so
that an evaluation never moves the training stream, as the JAX functions
split `train_state["rng"]` and leave it), or are injected through `draws`.
"""

import contextlib
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from small_vision_tpu_torch import convert, models, optim
from small_vision_tpu_torch.data import pipeline
from small_vision_tpu_torch.data import core as ds_core
from small_vision_tpu_torch.models.common import merge_params
from small_vision_tpu_torch.ops import diffusion as gd_lib
from small_vision_tpu_torch.parallel import collectives
from small_vision_tpu_torch.parallel import ctx as ctx_lib
from small_vision_tpu_torch.parallel import mesh as mesh_lib
from small_vision_tpu_torch.parallel.sharding import (ShardedParams,
                                                      infer_sharding,
                                                      reshard, unshard)
from small_vision_tpu_torch.pp.builder import DevicePP
from small_vision_tpu_torch.utils import checkpoint as ckpt_lib
from small_vision_tpu_torch.utils.chrono import Chrono
from small_vision_tpu_torch.utils.metrics import MetricWriter
from small_vision_tpu_torch.utils.misc import itstime, make_grid
from small_vision_tpu_torch.utils.schedules import steps
from small_vision_tpu_torch.utils.trees import tree_flatten_with_names


def build_model(config: dict, device="cuda",
                trainable: bool = False) -> torch.nn.Module:
  """The config's model, parameters uninitialised: in eval mode without
  gradients (the sampler's), or in train mode with them (`trainable`)."""
  model_mod = models.get_model_module(config.get("model_name", "ae"))
  with torch.device(device):
    model = model_mod.Model(**dict(config.get("model", {})))
  if trainable:
    return model.train().requires_grad_(True)
  return model.eval().requires_grad_(False)


def named_params(model: torch.nn.Module):
  """[(flax name, parameter)] in sorted-name order (JAX's leaf order)."""
  return sorted((n.replace(".", "/"), p) for n, p in model.named_parameters())


def mae_mix_weight(batch_size: int, no_noise_prob: float) -> float:
  """The MAE branch's loss weight: the realised fraction int(B*p)/B of the
  static split, not the nominal probability."""
  return int(batch_size * no_noise_prob) / batch_size


def make_optimizer(config: dict, names, total_steps: int,
                   warmup_steps: int) -> optim.AdamW:
  batch_size = int(config["input"]["batch_size"])
  return optim.AdamW(
      names, peak_lr=float(config.get("peak_lr", 15e-5)),
      batch_size=batch_size,
      total_steps=max(total_steps, warmup_steps + 1),
      warmup_steps=warmup_steps, wd=float(config.get("wd", 0.05)),
      betas=tuple(config.get("betas", (0.9, 0.95))),
      clip_norm=float(config.get("clip_norm", 1.0)),
      mu_dtype=config.get("mu_dtype", "bfloat16"))


def init_train_state(model, opt: optim.AdamW, config: dict,
                     device="cuda", params=None, opt_like=None) -> dict:
  """{"params", "opt", "generator", "gd"[, "ema_params"]}: the model's
  parameters (in `named_params` order; or `params`, the process's part of
  them under a sharding), the optimizer state (shaped as `opt_like`, the
  optimizer's placement, default `params`), the step's generator (seeded
  from config["seed"]), the diffusion tables, and with `ema_decay` a copy
  of the parameters for the EMA."""
  if params is None:
    params = [p for _, p in named_params(model)]
  sched = config.get("diff_schedule", {})
  state = {
      "params": params,
      "opt": opt.init(params if opt_like is None else opt_like),
      "generator": torch.Generator(device=device).manual_seed(
          int(config.get("seed", 0))),
      "gd": gd_lib.GaussianDiffusion.create(
          sched.get("beta_schedule", "cosine"),
          int(sched.get("timesteps", 1000)), device=device),
  }
  if config.get("ema_decay"):
    state["ema_params"] = [p.detach().clone() for p in params]
  return state


def _shard_draws(d, index, n_rows, n_noise, n_no_noise):
  """This process's rows of draws made for `count` processes' worth: the
  branches' draws by branch rows, the others by batch rows."""
  noise_keys = ("t", "noise", "dit_noise", "dit_drop")
  mae_keys = ("mae_noise", "mae_drop")
  out = {}
  for k, v in d.items():
    n = n_noise if k in noise_keys else n_no_noise if k in mae_keys else n_rows
    out[k] = v[index * n:(index + 1) * n]
  return out


def make_update_fn(model, opt: optim.AdamW, config: dict,
                   device_pp: Optional[DevicePP], vae_encode=None,
                   layout: Optional[ShardedParams] = None, mesh=None):
  """The training step, `update_fn(train_state, batch, draws=None, *,
  with_l2=False) -> measurements`.

  `batch`: {"image": (B, H, W, C) uint8 (or f32 when `device_pp` is None),
  "label": (B,)}, on the model's device or the host. `draws`: the step's
  random draws, {"t", "noise", "mae_noise", "dit_noise", "flip",
  "mae_drop", "dit_drop", "vae_noise"} as far as the step uses them (see
  `draw`), and with the model's dropout > 0 "dropout", the blocks' keep
  masks in the order the forward takes them; None draws them from the
  train state's generator (the dropout masks as the forward asks for
  them). With
  `latent_diffusion` and without `use_preprocessed_latents`, the images
  after the device pp go through `vae_encode(train_state["vae_params"],
  draws["vae_noise"], images)` (`models.vae.load_vae`), without
  gradients, and the step diffuses the latents. Updates the model's
  parameters, the optimizer state and the EMA in place; returns
  {"training_loss"} and, `with_l2`, the l2 norms of the parameters, the
  updates and the gradients (0-d tensors on the device).

  With a `layout` (`parallel.sharding.ShardedParams`, on `mesh`) the
  train state holds the process's part of each tensor and `batch` its rows
  of the global batch; the step gathers, reduces and updates as the
  module's doc says. Injected `draws` are the process's own; drawn ones are
  made for every process's rows and sliced, so that the generator moves
  alike everywhere. `training_loss` is the process's own.
  """
  no_noise_prob = float(config.get("no_noise_prob", 0.5))
  mask_ratio = float(config.get("mask_ratio", 0.375))
  mask_ratio_no_noise = float(config.get("mask_ratio_no_noise", 0.75))
  use_labels = bool(config.get("use_labels", False))
  ema_decay = config.get("ema_decay", None)
  fused_branches = bool(config.get("fused_branches", False))
  dspace = tuple(config.get("diffusion_space", (64, 64, 3)))
  channels = int(dspace[-1])
  encode = bool(config.get("latent_diffusion", False)) and not bool(
      config.get("use_preprocessed_latents", False))
  if encode and vae_encode is None:
    raise ValueError("latent_diffusion encodes the pixels in the step: pass "
                     "vae_encode (models.vae.load_vae)")
  num_patches = model.grid * model.grid
  device = next(model.parameters()).device
  shard_index, shard_count = mesh.batch_shard() if mesh else (0, 1)
  model_params = (layout.params if layout is not None
                  else [p for _, p in named_params(model)])

  def draw(b, image_shape, gen):
    n_no_noise = int(b * no_noise_prob)
    n_noise = b - n_no_noise
    if shard_count == 1:
      return draw_rows(b, n_noise, n_no_noise, image_shape, gen)
    c = shard_count
    return _shard_draws(
        draw_rows(c * b, c * n_noise, c * n_no_noise, image_shape, gen),
        shard_index, b, n_noise, n_no_noise)

  def draw_rows(b, n_noise, n_no_noise, image_shape, gen):
    d = device_pp.draw(b, gen, device) if device_pp is not None else {}
    if encode:  # the latent's draws, then the step's on the latents
      d["vae_noise"] = torch.randn((b,) + dspace, generator=gen,
                                   device=device)
      image_shape = dspace
    d["t"] = torch.randint(0, int(config.get("diff_schedule", {}).get(
        "timesteps", 1000)), (n_noise,), generator=gen, device=device)
    d["noise"] = torch.randn((n_noise,) + tuple(image_shape),
                             generator=gen, device=device)
    uniform = lambda *s: torch.rand(s, generator=gen, device=device)
    if n_no_noise and mask_ratio_no_noise > 0:
      d["mae_noise"] = uniform(n_no_noise, num_patches)
    if n_noise and mask_ratio > 0:
      d["dit_noise"] = uniform(n_noise, num_patches)
    if model.num_classes is not None:
      d["mae_drop"] = uniform(n_no_noise) < model.cfg_dropout_rate
      d["dit_drop"] = uniform(n_noise) < model.cfg_dropout_rate
    return d

  def dropout_draw(masks, gen):
    """The blocks' keep-mask function: the injected masks in turn, or
    Bernoulli draws from `gen`, made for every batch shard's rows and
    sliced as the step's other draws are (so that the processes on the
    batch axes draw the one-process masks, and those that differ only on
    `tensor` the same ones); None without dropout."""
    if not model.dropout:
      return None
    if masks is None:
      keep = 1.0 - model.dropout

      def bernoulli(shape):
        rows = shape[0]
        full = torch.rand((shard_count * rows,) + tuple(shape[1:]),
                          generator=gen, device=device)
        return full[shard_index * rows:(shard_index + 1) * rows] < keep
      return bernoulli
    masks = iter(masks)

    def take(shape):
      m = torch.as_tensor(next(masks)).to(device)
      if tuple(m.shape) != tuple(shape):
        raise ValueError(f"dropout mask of shape {tuple(m.shape)} where the "
                         f"forward draws {tuple(shape)}")
      return m.bool()
    return take

  def loss_and_grads(train_state, batch, draws=None):
    """(loss, gradients in `train_state["params"]` order) of one step."""
    batch = {k: torch.as_tensor(v).to(device, non_blocking=True)
             for k, v in batch.items()}
    b = batch["image"].shape[0]
    if draws is None:
      draws = draw(b, batch["image"].shape[1:], train_state["generator"])
      masks = None
    else:
      draws = dict(draws)
      masks = draws.pop("dropout", None)
      draws = {k: torch.as_tensor(v).to(device) for k, v in draws.items()}
    drop_fn = dropout_draw(masks, train_state["generator"])
    if device_pp is not None:
      batch = device_pp(batch, draws)
    images = batch["image"]
    if encode:
      with torch.no_grad(), torch.profiler.record_function("vae_encode"):
        images = vae_encode(train_state["vae_params"], draws["vae_noise"],
                            images)
    n_no_noise = int(b * no_noise_prob)  # the static split
    n_noise = b - n_no_noise
    x0_noise, x0_clean = images[:n_noise], images[n_noise:]
    labels_t = batch["label"][:n_noise].long() if use_labels else None
    noise = draws["noise"]
    t = draws["t"].long()
    x_t = gd_lib.q_sample(train_state["gd"], x0_noise, t, noise)

    def mae_branch_loss(pred, out):
      se = (pred[..., :channels] - x0_clean) ** 2
      return torch.mean(se * out["mask"]) / torch.mean(out["mask"])

    def dit_branch_loss(pred, out):
      # eps loss on the visible, x0 loss on the masked tokens.
      x0_se = (pred[..., :channels] - x0_noise) ** 2
      eps_se = (pred[..., channels:] - noise) ** 2
      mask = out["mask"]
      if mask is not None:
        eps_loss = torch.mean(eps_se * (1 - mask)) / torch.mean(1 - mask)
        x0_loss = torch.mean(x0_se * mask) / torch.mean(mask)
        return (eps_loss + x0_loss) / 2
      return (torch.mean(eps_se) + torch.mean(x0_se)) / 2

    if fused_branches and n_no_noise > 0 and n_noise > 0:
      drop = None
      if model.num_classes is not None:
        drop = torch.cat([draws["mae_drop"], draws["dit_drop"]])
      pred, out_mae, out_dit = model.dual_forward(
          x0_clean, x_t, t_b=t + 1, y_b=labels_t,
          mask_a=mask_ratio_no_noise, mask_b=mask_ratio, train=True,
          noise_a=draws.get("mae_noise"), noise_b=draws.get("dit_noise"),
          label_drop=drop, dropout_draw=drop_fn)
      mae_loss = mae_branch_loss(pred[:n_no_noise], out_mae)
      dit_loss = dit_branch_loss(pred[n_no_noise:], out_dit)
    else:
      mae_loss = dit_loss = 0.0
      if n_no_noise > 0:
        # MAE branch: clean input, t=0, heavy masking; loss on masked x0.
        pred, out = model(
            x0_clean, t=torch.zeros(n_no_noise, dtype=torch.long,
                                    device=device),
            train=True, mask=mask_ratio_no_noise,
            mask_noise=draws.get("mae_noise"),
            label_drop=draws.get("mae_drop"), dropout_draw=drop_fn)
        mae_loss = mae_branch_loss(pred, out)
      if n_noise > 0:
        # Diffusion branch: noised input at t+1 (t=0 is the clean input).
        pred, out = model(
            x_t, t=t + 1, y=labels_t, train=True, mask=mask_ratio,
            mask_noise=draws.get("dit_noise"),
            label_drop=draws.get("dit_drop"), dropout_draw=drop_fn)
        dit_loss = dit_branch_loss(pred, out)
    w_mae = mae_mix_weight(b, no_noise_prob)
    loss = dit_loss * (1.0 - w_mae) + mae_loss * w_mae
    return loss.detach(), list(torch.autograd.grad(loss, model_params))

  def update_fn(train_state, batch, draws=None, *, with_l2=False):
    if layout is None:
      loss, grads = loss_and_grads(train_state, batch, draws)
      with torch.no_grad(), torch.profiler.record_function("optimizer"):
        measurements = opt.step(train_state["params"], grads,
                                train_state["opt"], with_l2=with_l2)
    else:
      with ctx_lib.activate_mesh(mesh):
        with torch.profiler.record_function("gather_params"):
          layout.gather(train_state["params"])
        loss, grads = loss_and_grads(train_state, batch, draws)
        with torch.profiler.record_function("reduce_grads"):
          grads = layout.reduce_grads(grads)
        view = layout.opt_view(train_state["params"])
        if not layout.keeps_full_for_update:
          layout.release()
        with torch.no_grad(), torch.profiler.record_function("optimizer"):
          measurements = opt.step(view, grads, train_state["opt"],
                                  with_l2=with_l2, norm=layout.norm)
        with torch.profiler.record_function("commit_params"):
          layout.commit(train_state["params"], view)
        layout.release()
    with torch.no_grad(), torch.profiler.record_function("optimizer"):
      if ema_decay:
        optim.ema_update(train_state["ema_params"], train_state["params"],
                         ema_decay)
    measurements["training_loss"] = loss
    return measurements

  update_fn.loss_and_grads = loss_and_grads
  return update_fn


@contextlib.contextmanager
def swapped_params(params, other):
  """Runs a block with the tensors `other` standing in for the data of the
  parameters `params` (e.g. the EMA weights for the sampler); nothing is
  copied, and the parameters' own data is back afterwards."""
  saved = [p.data for p in params]
  for p, o in zip(params, other):
    p.data = o
  try:
    yield
  finally:
    for p, s in zip(params, saved):
      p.data = s


def eval_generator(train_state) -> torch.Generator:
  """A copy of the train state's generator, at its present position."""
  src = train_state["generator"]
  gen = torch.Generator(device=src.device)
  gen.set_state(src.get_state())
  return gen


def make_eval_fns(model, config: dict, vae_encode=None,
                  vae_decode=None) -> dict:
  """The functions the evaluators and the server consume: `predict`,
  `noised_predict`, `patch`, `loss`, and the sampler suite.

  With `latent_diffusion` they take the VAE's functions
  (`models.vae.load_vae`) and the train state's `vae_params`: each encodes
  its images first (its N(0, 1) draw "vae_noise" before the others),
  `patch` and `loss` decode what they return to pixels (`patch` resizes
  its mask to the image's size, nearest), and the sampler decodes its
  samples before they are clipped to uint8; a sampler function then needs
  a train state in place of `gd`."""
  dspace = tuple(config.get("diffusion_space", (64, 64, 3)))
  channels = int(dspace[-1])
  latent = bool(config.get("latent_diffusion", False))
  size = int(config.get("size", dspace[0]))
  if latent and (vae_encode is None or vae_decode is None):
    raise ValueError("latent_diffusion: pass vae_encode and vae_decode "
                     "(models.vae.load_vae)")
  use_labels = bool(config.get("use_labels", False))
  num_classes = config.get("num_classes", None)
  sched = config.get("diff_schedule", {})
  sampling_steps = int(sched.get("sampling_timesteps", 125))
  eta = float(sched.get("eta", 1.0))
  clip_denoised = bool(sched.get("clip_denoised", True))
  mask_ratio_no_noise = float(config.get("mask_ratio_no_noise", 0.75))
  params = [p for _, p in named_params(model)]
  num_patches = model.grid * model.grid

  def drawn(generator, draws, name, make):
    """The injected draw `name`, or `make(generator)`."""
    if draws is not None and name in draws:
      value = draws[name]
      if isinstance(value, np.ndarray):
        value = np.array(value)  # an owned, writable copy
      return torch.as_tensor(value).to(params[0].device)
    return make(generator)

  def to_latent(train_state, images, generator, draws):
    if not latent:
      return images
    noise = drawn(generator, draws, "vae_noise",
                  lambda g: torch.randn((images.shape[0],) + dspace,
                                        generator=g, device=images.device))
    return vae_encode(train_state["vae_params"], noise, images)

  def from_latent(vae_params, z):
    return vae_decode(vae_params, z) if latent else z

  @torch.no_grad()
  def predict_fn(train_state, batch, generator=None, *, draws=None):
    """Clean forward at t=0; `out` carries pre_logits for probes."""
    if latent:
      generator = generator or eval_generator(train_state)
    images = to_latent(train_state, batch["image"], generator, draws)
    _, out = model(images, t=torch.zeros(images.shape[0], dtype=torch.long,
                                         device=images.device))
    return None, out

  def make_noised_predict(t_value):
    @torch.no_grad()
    def noised_predict_fn(train_state, batch, generator=None, *, draws=None):
      generator = generator or eval_generator(train_state)
      images = to_latent(train_state, batch["image"], generator, draws)
      t = torch.full((images.shape[0],), t_value, dtype=torch.long,
                     device=images.device)
      noise = drawn(generator, draws, "noise",
                    lambda g: torch.randn(images.shape, generator=g,
                                          device=images.device))
      x_t = gd_lib.q_sample(train_state["gd"], images, t, noise)
      _, out = model(x_t, t=t + 1)
      return None, out
    return noised_predict_fn

  @torch.no_grad()
  def patch_fn(train_state, batch, generator=None, *, draws=None):
    """MAE reconstruction: masked clean forward, returns (pred_x0, mask)."""
    generator = generator or eval_generator(train_state)
    images = to_latent(train_state, batch["image"], generator, draws)
    b = images.shape[0]
    mae_noise = drawn(generator, draws, "mae_noise",
                      lambda g: torch.rand((b, num_patches), generator=g,
                                           device=images.device))
    pred, out = model(images, t=torch.zeros(b, dtype=torch.long,
                                            device=images.device),
                      mask=mask_ratio_no_noise, mask_noise=mae_noise)
    pred_x0, mask = pred[..., :channels], out["mask"]
    if latent:
      pred_x0 = from_latent(train_state["vae_params"], pred_x0)
      mask = torch.nn.functional.interpolate(
          mask.permute(0, 3, 1, 2), size=(size, size),
          mode="nearest").permute(0, 2, 3, 1)
    return pred_x0, mask

  @torch.no_grad()
  def loss_fn(train_state, batch, generator=None, *, draws=None):
    """Validation diffusion loss + visualization tensors: (per-example
    loss, x_t, pred_x0, pred_x0_eps). Per example, so that the evaluator can
    mask out the zero-padded rows of the final short batch."""
    generator = generator or eval_generator(train_state)
    images = to_latent(train_state, batch["image"], generator, draws)
    b = images.shape[0]
    gd = train_state["gd"]
    labels = batch.get("label") if use_labels else None
    t = drawn(generator, draws, "t",
              lambda g: torch.randint(0, gd.num_timesteps, (b,), generator=g,
                                      device=images.device)).long()
    noise = drawn(generator, draws, "noise",
                  lambda g: torch.randn(images.shape, generator=g,
                                        device=images.device))
    x_t = gd_lib.q_sample(gd, images, t, noise)
    pred, _ = model(x_t, y=None if labels is None else labels.long(),
                    t=t + 1)
    pred_x0, pred_eps = pred[..., :channels], pred[..., channels:]
    red = tuple(range(1, pred_eps.ndim))
    loss = (torch.mean((pred_eps - noise) ** 2, dim=red)
            + torch.mean((pred_x0 - images) ** 2, dim=red)) / 2
    pred_x0_eps = gd_lib.predict_xstart_from_eps(gd, x_t, t, pred_eps)
    if latent:
      x_t, pred_x0, pred_x0_eps = (
          from_latent(train_state["vae_params"], z)
          for z in (x_t, pred_x0, pred_x0_eps))
    return loss, x_t, pred_x0, pred_x0_eps

  def make_sample_fn(num_classes_arg=None, manual_ys=None, cfg_scale=None,
                     unnormalize=True, eps_pred=True):

    @torch.inference_mode()
    def sample(gd, generator, noise, vae_params=None):
      num_samples = int(config.get("num_samples_per_call", 1024))
      device = gd.betas.device
      if num_classes_arg is not None and manual_ys is None:
        # Class-balanced labels: every class once, random fill to the call
        # size; calls smaller than the class count cover the first classes.
        ys = torch.arange(min(num_classes_arg, num_samples), device=device)
        if num_samples > num_classes_arg:
          ys = torch.cat([ys, torch.randint(
              0, num_classes_arg, (num_samples - num_classes_arg,),
              generator=generator, device=device)])
      elif manual_ys is not None:
        ys = torch.as_tensor(manual_ys, device=device)
      else:
        ys = None

      out = gd_lib.ddim_sample_loop(
          gd, sampler_eps_fn(model, gd, channels, eps_pred),
          (num_samples,) + dspace, generator=generator, noise=noise, ys=ys,
          cfg_scale=cfg_scale, sampling_steps=sampling_steps, eta=eta,
          clip_denoised=clip_denoised)
      samples = out["sample"]
      if latent:
        samples = from_latent(vae_params, samples)
      if unnormalize:
        samples = torch.clamp(samples, -1, 1) * 0.5 + 0.5
        samples = torch.clamp(samples * 255, 0, 255).to(torch.uint8)

      n_show = int(config.get("num_samples", 36))
      show_idx = torch.randint(0, num_samples, (n_show,),
                               generator=generator, device=device)
      return {"fid_samples": samples, "image_examples": samples[show_idx],
              "ys": ys}

    def sample_fn(gd, generator, *, noise=None):
      if isinstance(gd, dict):  # a train state: its tables, its EMA weights
        train_state = gd
        with swapped_params(params, train_state.get("ema_params", params)):
          return sample(train_state["gd"], generator, noise,
                        train_state.get("vae_params"))
      if latent:
        raise ValueError("the latent sampler decodes with the train state's "
                         "vae_params: pass a train state, not its tables")
      return sample(gd, generator, noise)
    return sample_fn

  fns = {
      "predict": predict_fn,
      "noised_predict": make_noised_predict(50),
      "patch": patch_fn,
      "loss": loss_fn,
  }
  for name, kw in sampler_variants(num_classes).items():
    fns[name] = make_sample_fn(**kw)
  return fns


def sampler_variants(num_classes=None) -> dict:
  """{sampler name: its settings}: `num_classes_arg` (class-balanced
  labels), `cfg_scale`, `eps_pred` (False: the model's x0 prediction
  turned into eps)."""
  fns = {"uncond_eps": {}}
  if num_classes:
    fns["cond_eps"] = {"num_classes_arg": num_classes}
    for scale in (1.0, 1.5, 2.0, 4.0):
      fns[f"cfg_eps_{scale}"] = {"num_classes_arg": num_classes,
                                 "cfg_scale": scale}
    for scale in (2.0, 4.0):
      fns[f"cfg_x0_{scale}"] = {"num_classes_arg": num_classes,
                                "cfg_scale": scale, "eps_pred": False}
  return fns


def sampler_eps_fn(model, gd, channels: int, eps_pred: bool = True):
  """The sampler's eps model: the t+1 shift and optional CFG."""

  def apply_fn(*, x_t, t, y=None, cfg_scale=None):
    pred, _ = model(x_t, t=t + 1, y=y, cfg_scale=cfg_scale)
    if eps_pred:
      return pred[..., channels:]
    return gd_lib.predict_eps_from_xstart(gd, x_t, t, pred[..., :channels])
  return apply_fn


_STRATEGIES = ("replicated", "fully_sharded", "tensor_parallel", "tp_fsdp")


def check_parallel_config(config: dict) -> tuple:
  """(parameter strategy, optimizer strategy, VAE strategy) of the config,
  each defaulting to `replicated` as in JAX; raises on what the port does
  not run."""
  param_sharding = config.get("param_sharding", "replicated")
  optim_sharding = config.get("optim_sharding", "replicated")
  vae_sharding = config.get("vae_param_sharding", "replicated")
  if "pipeline" in (param_sharding, optim_sharding) and (
      optim_sharding != param_sharding):
    raise ValueError(f"optim_sharding={optim_sharding!r} with param_sharding="
                     f"{param_sharding!r}: a pipeline's optimizer state "
                     "follows its stages (optim_sharding='pipeline')")
  pipelined = param_sharding == "pipeline" or int(dict(config.get(
      "model", {})).get("pipe_stages", 0) or 0) > 1
  if pipelined and int(config.get("mesh_tensor", 1)) > 1:
    raise NotImplementedError(
        "a pipeline with mesh_tensor > 1: the JAX trainer builds no mesh "
        "with both a pipe and a tensor axis (ROADMAP.md Queue A)")
  if vae_sharding not in _STRATEGIES:
    raise ValueError(f"vae_param_sharding={vae_sharding!r}: one of "
                     f"{_STRATEGIES}")
  return param_sharding, optim_sharding, vae_sharding


def _specs(config: dict, tree, mesh, strategy) -> dict:
  """infer_sharding of `tree` by `strategy`, `fully_sharded` (and the
  fsdp part of `tp_fsdp`) over `min_size_to_shard` elements (2^18 by
  default)."""
  kw = ({"min_size_to_shard": int(config["min_size_to_shard"])}
        if strategy in ("fully_sharded", "tp_fsdp")
        and "min_size_to_shard" in config else {})
  return infer_sharding(tree, mesh, strategy, **kw)


def make_layout(config: dict, mesh, named) -> Optional[ShardedParams]:
  """The `ShardedParams` of the named parameters `named` ([(name,
  parameter)]) on `mesh` by `param_sharding` and `optim_sharding`; None
  on a mesh of one process."""
  if mesh is None or mesh.size <= 1:
    return None
  param_strategy, opt_strategy, _ = check_parallel_config(config)
  names = [n for n, _ in named]

  def specs(strategy):
    got = _specs(config, dict(named), mesh, strategy)
    return [got[n] for n in names]
  return ShardedParams(names, [p for _, p in named], specs(param_strategy),
                       mesh, opt_specs=specs(opt_strategy))


def build_mesh(config: dict):
  """The trainer's mesh from `mesh_fsdp` (0: every process on it) and
  `mesh_tensor`, as JAX `train_ae.py` builds it. A pipeline's mesh is
  given to `train_and_evaluate`."""
  check_parallel_config(config)
  return mesh_lib.make_mesh(fsdp=int(config.get("mesh_fsdp", 1)),
                            tensor=int(config.get("mesh_tensor", 1)))


def setup_training(config: dict, device="cuda", log=print,
                   mesh=None) -> dict:
  """Everything a training run needs, from the config: the input pipeline
  (`train_iter`, a `data.pipeline.TrainIterator` on `device`: set its
  `start_step` to continue the stream after that many steps), the model
  with `init_train_params` weights, AdamW, the train state and the step,
  which applies the iterator's device pp; with `latent_diffusion` the VAE
  (`models.vae.load_vae` of `config["vae_weights"]`, seeded without it),
  its parameters in the train state as `vae_params`. Returns a dict of
  those and of `names`, `vae_encode`, `vae_decode`, `total_steps`,
  `batch_size`, `ntrain_img`, `log_steps`, `get_steps(name, default)`
  and `layout`: on a `mesh` of several processes the
  `parallel.sharding.ShardedParams` the train state's tensors follow (the
  process's parts, by `param_sharding` and `optim_sharding`; see
  `make_layout`), else None."""
  _, _, vae_strategy = check_parallel_config(config)
  batch_size = int(config["input"]["batch_size"])
  if mesh is not None:  # each process reads its batch shard's data
    ds_core.set_process_shard(*mesh.batch_shard())
  train_iter, device_pp, ntrain_img = pipeline.training(config["input"],
                                                        device)
  total_steps = steps("total", config, ntrain_img, batch_size)
  get_steps = lambda name, default=ValueError: steps(
      name, config, ntrain_img, batch_size, total_steps, default)
  warmup_steps = get_steps("warmup", None) or max(int(0.05 * total_steps), 1)
  log(f"{total_steps} steps ({total_steps * batch_size / ntrain_img:.3f} "
      f"epochs) at batch {batch_size} on {device}")

  model = build_model(config, device=device, trainable=True)
  model.load_state_dict(convert.params_from_jax(
      convert.init_train_params(config, int(config.get("seed", 0))), model))
  names = [n for n, _ in named_params(model)]
  opt = make_optimizer(config, names, total_steps, warmup_steps)
  layout = make_layout(config, mesh, named_params(model))
  opt_like = None
  if layout is not None:
    opt_like = [torch.empty(s, device=device) for s in layout.opt_shapes()]
  train_state = init_train_state(
      model, opt, config, device,
      params=None if layout is None else layout.shard_state(),
      opt_like=opt_like)
  vae_encode = vae_decode = None
  if config.get("latent_diffusion"):
    from small_vision_tpu_torch.models import vae as vae_lib
    vae_params, vae_encode, vae_decode = vae_lib.load_vae(
        config.get("vae_weights") or None,
        image_size=int(config.get("size", 256)), device=device)
    if layout is not None and vae_strategy != "replicated":
      layout.vae_specs = _specs(config, vae_params, mesh, vae_strategy)
      vae_encode, vae_decode = (_on_full_vae(f, layout)
                                for f in (vae_encode, vae_decode))
      vae_params = {n: t.clone(memory_format=torch.contiguous_format)
                    for n, t in reshard(vae_params, layout.vae_specs,
                                        mesh).items()}
    train_state["vae_params"] = vae_params
  return {
      "model": model, "opt": opt, "train_state": train_state, "names": names,
      "update_fn": make_update_fn(model, opt, config, device_pp,
                                  vae_encode=vae_encode, layout=layout,
                                  mesh=mesh),
      "layout": layout, "mesh": mesh,
      "vae_encode": vae_encode, "vae_decode": vae_decode,
      "train_iter": train_iter,
      "total_steps": total_steps, "batch_size": batch_size,
      "ntrain_img": ntrain_img, "get_steps": get_steps,
      "log_steps": get_steps("log_training", 100),
  }


def _on_full_vae(fn, layout):
  """`fn(vae_params, ...)` of the VAE's functions on this process's parts
  of its parameters: gathered (an all-gather of each sharded leaf) for the
  call."""
  return lambda params, *a, **kw: fn(
      unshard(params, layout.vae_specs, layout.mesh), *a, **kw)


def _named(names, tensors) -> dict:
  return dict(zip(names, tensors))


def checkpoint_state(train_state, names, chrono: Chrono,
                     layout: Optional[ShardedParams] = None) -> dict:
  """The entries a checkpoint holds, each a flat {name: leaf} tree: the
  parameters, the EMA's, the optimizer's (`mu` bf16, `nu`, count), the
  generator's state, Chrono's accumulated time and, on the latent path,
  the VAE's parameters (`vae_params`, by state_dict name). With a
  `layout` each leaf is gathered to its full form (every process takes
  part)."""
  full = layout.full if layout is not None else (lambda ts, opt=False: ts)
  opt = train_state["opt"]
  state = {
      "params": _named(names, full(train_state["params"])),
      "opt": {"count": np.int64(opt["count"]),
              **{f"mu/{n}": t for n, t in zip(names, full(opt["mu"], True))},
              **{f"nu/{n}": t
                 for n, t in zip(names, full(opt["nu"], True))}},
      "generator": {"state": train_state["generator"].get_state()},
      "chrono": {"accum_train_time": chrono.save()},
  }
  if "ema_params" in train_state:
    state["ema_params"] = _named(names, full(train_state["ema_params"]))
  if "vae_params" in train_state:
    vae = dict(train_state["vae_params"])
    if layout is not None and layout.vae_specs is not None:
      vae = unshard(vae, layout.vae_specs, layout.mesh)
    state["vae_params"] = vae
  return state


def _copy_named(names, tensors, tree, what, skip=(), layout=None,
                opt=False):
  """Copies the restored `tree` into `tensors` (in `names` order), leaf by
  leaf; names whose first token is in `skip` keep what they hold. With a
  `layout` the tree's leaves are full and each tensor takes its part (in
  the optimizer's placement with `opt`)."""
  flat = dict(tree_flatten_with_names(tree))
  want = [n for n in names if n.split("/")[0] not in skip]
  missing = sorted(set(want) - set(flat))
  if missing:
    raise KeyError(f"checkpoint {what} lacks {missing[:8]}")
  with torch.no_grad():
    for i, (n, t) in enumerate(zip(names, tensors)):
      if n in flat and n.split("/")[0] not in skip:
        shape = (layout.full_shapes[i] if layout is not None
                 else tuple(t.shape))
        if tuple(flat[n].shape) != shape:
          raise ValueError(f"{what} {n}: checkpoint shape "
                           f"{tuple(flat[n].shape)} != {shape}")
        t.copy_(flat[n] if layout is None else layout.local(i, flat[n],
                                                            opt))


def load_checkpoint_state(train_state, names, restored, chrono: Chrono,
                          layout: Optional[ShardedParams] = None):
  """Puts a restored checkpoint into the live train state, in place (with a
  `layout`, each process its parts of the full leaves)."""
  _copy_named(names, train_state["params"], restored["params"], "params",
              layout=layout)
  if "ema_params" in train_state:
    _copy_named(names, train_state["ema_params"], restored["ema_params"],
                "ema_params", layout=layout)
  opt = restored["opt"]
  train_state["opt"]["count"] = int(opt["count"])
  _copy_named(names, train_state["opt"]["mu"], opt["mu"], "opt/mu",
              layout=layout, opt=True)
  _copy_named(names, train_state["opt"]["nu"], opt["nu"], "opt/nu",
              layout=layout, opt=True)
  train_state["generator"].set_state(restored["generator"]["state"])
  chrono.load(restored["chrono"]["accum_train_time"])
  if "vae_params" in train_state:
    vae = train_state["vae_params"]
    tree = dict(tree_flatten_with_names(restored["vae_params"]))
    if layout is not None and layout.vae_specs is not None:
      tree = reshard(tree, layout.vae_specs, layout.mesh)
    _copy_named(list(vae), list(vae.values()), tree, "vae_params")


def train_and_evaluate(config: dict, workdir: Optional[str] = None,
                       device="cuda", log=print, mesh=None) -> tuple:
  """Runs the training loop; returns (train_state, history).

  On `mesh` (default: `build_mesh(config)`, one process without a process
  group) with several processes, each process runs its part (see the
  module's doc); the returned train state holds the process's parts.

  With a `workdir` the run writes `sv_tpu_metrics.txt` and `config.json`
  there, checkpoints every `ckpt_steps` under `checkpoints/` (a finetune
  run under `finetune/checkpoints/`), resumes from the newest checkpoint
  when one is there (parameters, EMA, optimizer, the generator's state and
  the position in the data stream, so that a resumed run computes what an
  uninterrupted one would), and writes the evaluators' image grids (.npy)
  and samples (.npz). `config["model_init"]` warm-starts from a flat npz;
  `config["finetune"]` / `config["resume"]` take parameters (and EMA) from a
  pretrain checkpoint and keep a fresh label head and optimizer.

  history has one entry per step run here, {"step", "ms", "data_ms"}
  ("ms": host clock around the step, which ends in a device
  synchronisation; "data_ms": the wait for its batch from the input
  pipeline before it), plus
  "training_loss", the l2 norms and "epochs" on log steps. Raises when the
  loss is not finite on a log step. With `force_eval` the evaluators run
  once and the function returns with an empty history.

  The JAX loop's `profile_flops` (XLA's cost analysis) and `profile`
  (`jax.profiler`) have no counterpart here: `tools/profile_train.py`
  traces a step with torch.profiler.
  """
  mesh = mesh if mesh is not None else build_mesh(config)
  try:
    return _train_and_evaluate(config, workdir, device, log, mesh)
  finally:
    ds_core.set_process_shard(None)


def _train_and_evaluate(config, workdir, device, log, mesh):
  writer = mesh_lib.process_index() == 0
  if not writer:  # process 0 alone logs and writes
    log = lambda s: None
  chrono = Chrono(device=device)
  mw = MetricWriter(workdir if writer else None, config,
                    sinks=None if writer else [])
  run = setup_training(config, device, log, mesh)
  total_steps, batch_size = run["total_steps"], run["batch_size"]
  ntrain_img, get_steps = run["ntrain_img"], run["get_steps"]
  train_state, update_fn = run["train_state"], run["update_fn"]
  model, names, opt = run["model"], run["names"], run["opt"]
  layout = run["layout"]
  note = lambda s: log(f"NOTE: {s}")
  chrono.inform(total_steps=total_steps, global_bs=batch_size,
                steps_per_epoch=ntrain_img / batch_size,
                measure=mw.measure, write_note=note)
  mw.measure("num_params", sum(p.numel() for _, p in named_params(model))
             if layout is None else sum(
                 int(np.prod(s)) for s in layout.full_shapes))

  def reset_ema():
    if "ema_params" in train_state:
      with torch.no_grad():
        for e, p in zip(train_state["ema_params"], train_state["params"]):
          e.copy_(p)

  if config.get("model_init"):
    # Warm start from a flat-npz zoo checkpoint.
    merged = merge_params(
        ckpt_lib.load_params_npz(config["model_init"]),
        _named(names, train_state["params"] if layout is None
               else layout.full(train_state["params"])),
        dont_load=tuple(config.get("model_load", {}).get("dont_load", ())))
    _copy_named(names, train_state["params"], merged, "model_init",
                layout=layout)
    reset_ema()

  # Checkpoint resume. A finetune run writes to its own subdirectory; on
  # its first start it performs "surgery" on the pretrain checkpoint: fresh
  # label embedder/trunk + fresh optimizer.
  ckpt_dir = workdir
  if workdir and config.get("finetune"):
    ckpt_dir = os.path.join(workdir, "finetune")
  ckpt_mngr = None
  # `force_eval` restores too (tools/eval_only.py evaluates the newest
  # checkpoint; the JAX trainer restores only with save_ckpt or resume).
  if ckpt_dir and (config.get("save_ckpt", True) or config.get("resume")
                   or config.get("force_eval")):
    ckpt_mngr = ckpt_lib.make_manager(
        ckpt_dir, keep_period=get_steps("keep_ckpt", None), writer=writer)
    # Every process restores the step process 0 sees.
    latest = int(collectives.broadcast_one_to_all(
        np.int64(-1 if ckpt_mngr.latest_step() is None
                 else ckpt_mngr.latest_step())))
    restored = (ckpt_lib.restore(ckpt_mngr, latest) if latest >= 0
                else None)
    if restored is not None:
      note(f"Resumed from step {latest}")
      load_checkpoint_state(train_state, names, restored, chrono, layout)
    elif config.get("finetune") or config.get("resume"):
      src_dir = config.get("resume") or workdir
      src_mngr = (ckpt_lib.make_manager(src_dir)
                  if src_dir != ckpt_dir else ckpt_mngr)
      if src_mngr.latest_step() is not None:
        note(f"Finetune surgery from {src_dir} step {src_mngr.latest_step()}")
        _copy_named(names, train_state["params"],
                    ckpt_lib.restore_subtree(src_mngr, "params"), "params",
                    skip=("label_embed", "label_trunk"), layout=layout)
        reset_ema()
        train_state["opt"] = opt.init(
            train_state["params"] if layout is None else
            [torch.empty(s, device=device) for s in layout.opt_shapes()])

  eval_fns = make_eval_fns(model, config, vae_encode=run["vae_encode"],
                           vae_decode=run["vae_decode"])
  evaluators = []
  if config.get("evals"):
    from small_vision_tpu_torch.evaluators import common as eval_common
    evaluators = eval_common.from_config(
        config, eval_fns, device,
        lambda key, cfg: steps(key, cfg, ntrain_img, batch_size, total_steps,
                               default=None), mesh=mesh)

  @contextlib.contextmanager
  def eval_state():
    """The train state as the evaluators see it: the full parameters in the
    model (and a full EMA), under the active mesh."""
    if layout is None:
      yield train_state
      return
    with ctx_lib.activate_mesh(mesh):
      layout.gather(train_state["params"])
      state = dict(train_state, params=layout.params)
      if "ema_params" in train_state:
        state["ema_params"] = layout.model_view(train_state["ema_params"])
      try:
        yield state
      finally:
        layout.release()

  def handle_eval_results(name, prefix, results, step):
    """Logs an evaluator's outputs; `fid_samples` are scored (FID and IS,
    where the config has `inception_reference_path`) and dumped as .npz,
    image tensors as .npy grids under the workdir."""
    for key, value in results:
      if key == "fid_samples":
        ref_stats = config.get("inception_reference_path")
        if ref_stats and writer:
          from small_vision_tpu_torch.evaluators.fid import create_fid_score_fn
          fid_fn = create_fid_score_fn(config.get("fid_batch_size", 1024),
                                       ref_stats,
                                       config.get("inception_weights"),
                                       device=device)
          fid_score, is_score = fid_fn(value["samples"])
          mw.measure(f"{prefix}{key}_fid_score", fid_score)
          mw.measure(f"{prefix}{key}_inception_score", is_score)
        if workdir and writer:
          out_dir = os.path.join(workdir, f"{name}_samples")
          os.makedirs(out_dir, exist_ok=True)
          ys = value["ys"]
          np.savez(os.path.join(out_dir, f"samples_{step}.npz"),
                   samples=value["samples"],
                   ys=ys if ys is not None else np.zeros(0))
      elif key.startswith("image"):
        if workdir and writer:
          grid = make_grid(value, num_samples=config.get("num_samples", 36))
          out_dir = os.path.join(workdir, "grids")
          os.makedirs(out_dir, exist_ok=True)
          np.save(os.path.join(out_dir, f"{name}_{key}_{step}.npy"), grid)
      else:
        mw.measure(f"{prefix}{key}", value)

  first_step = int(train_state["opt"]["count"])
  chrono.inform(first_step=first_step)
  note(f"Starting at step {first_step + 1}/{total_steps}")

  if config.get("force_eval") or first_step == total_steps:
    mw.step_start(first_step)
    for (name, evaluator, _, prefix) in evaluators:
      note(f"{name} evaluation (forced)...")
      with eval_state() as state:
        handle_eval_results(name, prefix, evaluator.run(state), first_step)
    mw.step_end()
    if config.get("force_eval"):
      mw.close()
      return train_state, []

  log_steps = run["log_steps"]
  ckpt_steps = get_steps("ckpt", None)
  # Deterministic data resume: the stream continues where the stopped run's
  # step count left it.
  run["train_iter"].start_step = first_step
  batches = iter(run["train_iter"])
  sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
          else lambda: None)
  history = []
  try:
    for step in range(first_step + 1, total_steps + 1):
      t_data = time.perf_counter()
      batch = next(batches)
      mw.step_start(step)
      log_now = itstime(step, log_steps, total_steps)
      t0 = time.perf_counter()
      measurements = update_fn(train_state, batch, with_l2=log_now)
      sync()
      entry = {"step": step, "ms": (time.perf_counter() - t0) * 1e3,
               "data_ms": (t0 - t_data) * 1e3}
      if log_now:
        if layout is not None:  # the mean of the processes' losses
          collectives.all_reduce(measurements["training_loss"],
                                 mesh.batch_group(), "mean")
        measurements = {k: float(v) for k, v in measurements.items()}
        measurements["epochs"] = step * batch_size / ntrain_img
        for name, value in measurements.items():
          mw.measure(name, value)
        chrono.tick(step)
        entry.update(measurements)
        log(f"step {step}/{total_steps}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in entry.items() if k != "step"))
        if not math.isfinite(entry["training_loss"]):
          raise RuntimeError(f"Loss became NaN/Inf within steps "
                             f"[{step - log_steps}, {step}]")
      history.append(entry)

      if ckpt_mngr and config.get("save_ckpt", True) and itstime(
          step, ckpt_steps, total_steps, first=False):
        chrono.pause(wait_for=train_state["params"])
        with torch.profiler.record_function("checkpoint"):
          state = checkpoint_state(train_state, names, chrono, layout)
          if writer:
            ckpt_lib.save(ckpt_mngr, state, step)
        chrono.resume()

      for (name, evaluator, ev_steps, prefix) in evaluators:
        if itstime(step, ev_steps, total_steps, first=False, last=True):
          chrono.pause(wait_for=train_state["params"])
          chrono.tick(step)
          note(f"{name} evaluation at step {step}...")
          with torch.profiler.record_function("evaluator"), \
              eval_state() as state:
            handle_eval_results(name, prefix, evaluator.run(state), step)
          chrono.resume()

      mw.step_end()
  finally:
    batches.close()  # stops the input pipeline's producer thread

  if ckpt_mngr:
    ckpt_lib.wait_until_finished(ckpt_mngr)
  mw.close()
  return train_state, history
