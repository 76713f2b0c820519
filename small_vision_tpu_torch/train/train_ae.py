"""The UMD trainer: the model builder, the training step, a minimal train
loop, and the sampler functions.

Counterpart of small_vision_tpu/train/train_ae.py: `build_model`,
`mae_mix_weight`, `make_update_fn` (the joint MAE + diffusion step: device
pp, q_sample, the two branches, the loss mix, AdamW, EMA), `make_eval_fns`
(predict, noised_predict, patch, loss, and the sampler suite: uncond_eps,
and with `num_classes` cond_eps, cfg_eps_* and cfg_x0_*), and
`train_and_evaluate`: the loop on one card with `Chrono`, the metric
writer, warm start, resumable checkpoints, the finetune surgery, the
evaluators and the NaN abort. The latent (VAE) hooks and the mesh come with
their slices.

The step's random draws (t, noise, the two branches' mask noise, the flip
mask and the label-drop masks) come from the train state's
`torch.Generator`, or are injected, so that a test can drive the step with
the JAX package's draws.

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
import importlib
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from small_vision_tpu_torch import convert, optim
from small_vision_tpu_torch.data import core as ds_core
from small_vision_tpu_torch.data import synthetic
from small_vision_tpu_torch.models.common import merge_params
from small_vision_tpu_torch.ops import diffusion as gd_lib
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
  model_mod = importlib.import_module(
      f"small_vision_tpu_torch.models.{config.get('model_name', 'ae')}")
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
                     device="cuda") -> dict:
  """{"params", "opt", "generator", "gd"[, "ema_params"]}: the model's
  parameters (in `named_params` order), the optimizer state, the step's
  generator (seeded from config["seed"]), the diffusion tables, and with
  `ema_decay` a copy of the parameters for the EMA."""
  params = [p for _, p in named_params(model)]
  sched = config.get("diff_schedule", {})
  state = {
      "params": params,
      "opt": opt.init(params),
      "generator": torch.Generator(device=device).manual_seed(
          int(config.get("seed", 0))),
      "gd": gd_lib.GaussianDiffusion.create(
          sched.get("beta_schedule", "cosine"),
          int(sched.get("timesteps", 1000)), device=device),
  }
  if config.get("ema_decay"):
    state["ema_params"] = [p.detach().clone() for p in params]
  return state


def make_update_fn(model, opt: optim.AdamW, config: dict,
                   device_pp: Optional[DevicePP]):
  """The training step, `update_fn(train_state, batch, draws=None, *,
  with_l2=False) -> measurements`.

  `batch`: {"image": (B, H, W, C) uint8 (or f32 when `device_pp` is None),
  "label": (B,)}, on the model's device or the host. `draws`: the step's
  random draws, {"t", "noise", "mae_noise", "dit_noise", "flip",
  "mae_drop", "dit_drop"} as far as the step uses them (see `draw`);
  None draws them from the train state's generator. Updates the model's
  parameters, the optimizer state and the EMA in place; returns
  {"training_loss"} and, `with_l2`, the l2 norms of the parameters, the
  updates and the gradients (0-d tensors on the device).
  """
  no_noise_prob = float(config.get("no_noise_prob", 0.5))
  mask_ratio = float(config.get("mask_ratio", 0.375))
  mask_ratio_no_noise = float(config.get("mask_ratio_no_noise", 0.75))
  use_labels = bool(config.get("use_labels", False))
  ema_decay = config.get("ema_decay", None)
  fused_branches = bool(config.get("fused_branches", False))
  channels = int(config.get("diffusion_space", (64, 64, 3))[-1])
  num_patches = model.grid * model.grid
  device = next(model.parameters()).device

  def draw(b, image_shape, gen):
    n_no_noise = int(b * no_noise_prob)
    n_noise = b - n_no_noise
    d = device_pp.draw(b, gen, device) if device_pp is not None else {}
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

  def loss_and_grads(train_state, batch, draws=None):
    """(loss, gradients in `train_state["params"]` order) of one step."""
    batch = {k: torch.as_tensor(v).to(device, non_blocking=True)
             for k, v in batch.items()}
    b = batch["image"].shape[0]
    if draws is None:
      draws = draw(b, batch["image"].shape[1:], train_state["generator"])
    else:
      draws = {k: torch.as_tensor(v).to(device) for k, v in draws.items()}
    if device_pp is not None:
      batch = device_pp(batch, draws)
    images = batch["image"]
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
          label_drop=drop)
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
            label_drop=draws.get("mae_drop"))
        mae_loss = mae_branch_loss(pred, out)
      if n_noise > 0:
        # Diffusion branch: noised input at t+1 (t=0 is the clean input).
        pred, out = model(
            x_t, t=t + 1, y=labels_t, train=True, mask=mask_ratio,
            mask_noise=draws.get("dit_noise"),
            label_drop=draws.get("dit_drop"))
        dit_loss = dit_branch_loss(pred, out)
    w_mae = mae_mix_weight(b, no_noise_prob)
    loss = dit_loss * (1.0 - w_mae) + mae_loss * w_mae
    return loss.detach(), list(torch.autograd.grad(loss,
                                                   train_state["params"]))

  def update_fn(train_state, batch, draws=None, *, with_l2=False):
    loss, grads = loss_and_grads(train_state, batch, draws)
    with torch.no_grad(), torch.profiler.record_function("optimizer"):
      measurements = opt.step(train_state["params"], grads,
                              train_state["opt"], with_l2=with_l2)
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


def make_eval_fns(model, config: dict) -> dict:
  """The functions the evaluators and the server consume: `predict`,
  `noised_predict`, `patch`, `loss`, and the sampler suite."""
  dspace = tuple(config.get("diffusion_space", (64, 64, 3)))
  channels = int(dspace[-1])
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

  @torch.no_grad()
  def predict_fn(train_state, batch, generator=None, *, draws=None):
    """Clean forward at t=0; `out` carries pre_logits for probes."""
    del train_state, generator, draws
    images = batch["image"]
    _, out = model(images, t=torch.zeros(images.shape[0], dtype=torch.long,
                                         device=images.device))
    return None, out

  def make_noised_predict(t_value):
    @torch.no_grad()
    def noised_predict_fn(train_state, batch, generator=None, *, draws=None):
      generator = generator or eval_generator(train_state)
      images = batch["image"]
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
    images = batch["image"]
    b = images.shape[0]
    mae_noise = drawn(generator, draws, "mae_noise",
                      lambda g: torch.rand((b, num_patches), generator=g,
                                           device=images.device))
    pred, out = model(images, t=torch.zeros(b, dtype=torch.long,
                                            device=images.device),
                      mask=mask_ratio_no_noise, mask_noise=mae_noise)
    return pred[..., :channels], out["mask"]

  @torch.no_grad()
  def loss_fn(train_state, batch, generator=None, *, draws=None):
    """Validation diffusion loss + visualization tensors: (per-example
    loss, x_t, pred_x0, pred_x0_eps). Per example, so that the evaluator can
    mask out the zero-padded rows of the final short batch."""
    generator = generator or eval_generator(train_state)
    images = batch["image"]
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
    return loss, x_t, pred_x0, pred_x0_eps

  def make_apply_fn(gd, eps_pred=True):
    """The sampler's eps model: the t+1 shift and optional CFG."""

    def apply_fn(*, x_t, t, y=None, cfg_scale=None):
      pred, _ = model(x_t, t=t + 1, y=y, cfg_scale=cfg_scale)
      if eps_pred:
        return pred[..., channels:]
      return gd_lib.predict_eps_from_xstart(gd, x_t, t, pred[..., :channels])
    return apply_fn

  def make_sample_fn(num_classes_arg=None, manual_ys=None, cfg_scale=None,
                     unnormalize=True, eps_pred=True):

    @torch.inference_mode()
    def sample(gd, generator, noise):
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
          gd, make_apply_fn(gd, eps_pred=eps_pred),
          (num_samples,) + dspace, generator=generator, noise=noise, ys=ys,
          cfg_scale=cfg_scale, sampling_steps=sampling_steps, eta=eta,
          clip_denoised=clip_denoised)
      samples = out["sample"]
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
          return sample(train_state["gd"], generator, noise)
      return sample(gd, generator, noise)
    return sample_fn

  fns = {
      "predict": predict_fn,
      "noised_predict": make_noised_predict(50),
      "patch": patch_fn,
      "loss": loss_fn,
      "uncond_eps": make_sample_fn(),
  }
  if num_classes:
    fns.update({
        "cond_eps": make_sample_fn(num_classes),
        "cfg_eps_1.0": make_sample_fn(num_classes, cfg_scale=1.0),
        "cfg_eps_1.5": make_sample_fn(num_classes, cfg_scale=1.5),
        "cfg_eps_2.0": make_sample_fn(num_classes, cfg_scale=2.0),
        "cfg_eps_4.0": make_sample_fn(num_classes, cfg_scale=4.0),
        "cfg_x0_2.0": make_sample_fn(num_classes, cfg_scale=2.0,
                                     eps_pred=False),
        "cfg_x0_4.0": make_sample_fn(num_classes, cfg_scale=4.0,
                                     eps_pred=False),
    })
  return fns


def setup_training(config: dict, device="cuda", log=print) -> dict:
  """Everything a training run needs, from the config: the source's batches
  (`batches_from(step)`: the stream after `step` steps), the model with
  `init_train_params` weights, AdamW, the train state, the device pp and
  the step. Returns a dict of those and of `names`, `total_steps`,
  `batch_size`, `ntrain_img`, `log_steps` and `get_steps(name, default)`."""
  in_cfg = dict(config["input"])
  batch_size = int(in_cfg["batch_size"])
  data_cfg = dict(in_cfg["data"])
  source = ds_core.get(data_cfg.pop("name"), **data_cfg)
  ntrain_img = source.total_examples
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
  train_state = init_train_state(model, opt, config, device)
  device_pp = DevicePP(in_cfg.get("pp", ""))
  batches_from = lambda step: synthetic.batches(
      source, batch_size, seed=int(config.get("seed", 0)), start_step=step)
  return {
      "model": model, "opt": opt, "train_state": train_state, "names": names,
      "update_fn": make_update_fn(model, opt, config, device_pp),
      "batches_from": batches_from,
      "total_steps": total_steps, "batch_size": batch_size,
      "ntrain_img": ntrain_img, "get_steps": get_steps,
      "log_steps": get_steps("log_training", 100),
  }


def _named(names, tensors) -> dict:
  return dict(zip(names, tensors))


def checkpoint_state(train_state, names, chrono: Chrono) -> dict:
  """The entries a checkpoint holds, each a flat {name: leaf} tree: the
  parameters, the EMA's, the optimizer's (`mu` bf16, `nu`, count), the
  generator's state and Chrono's accumulated time."""
  opt = train_state["opt"]
  state = {
      "params": _named(names, train_state["params"]),
      "opt": {"count": np.int64(opt["count"]),
              **{f"mu/{n}": t for n, t in zip(names, opt["mu"])},
              **{f"nu/{n}": t for n, t in zip(names, opt["nu"])}},
      "generator": {"state": train_state["generator"].get_state()},
      "chrono": {"accum_train_time": chrono.save()},
  }
  if "ema_params" in train_state:
    state["ema_params"] = _named(names, train_state["ema_params"])
  return state


def _copy_named(names, tensors, tree, what, skip=()):
  """Copies the restored `tree` into `tensors` (in `names` order), leaf by
  leaf; names whose first token is in `skip` keep what they hold."""
  flat = dict(tree_flatten_with_names(tree))
  want = [n for n in names if n.split("/")[0] not in skip]
  missing = sorted(set(want) - set(flat))
  if missing:
    raise KeyError(f"checkpoint {what} lacks {missing[:8]}")
  with torch.no_grad():
    for n, t in zip(names, tensors):
      if n in flat and n.split("/")[0] not in skip:
        if tuple(flat[n].shape) != tuple(t.shape):
          raise ValueError(f"{what} {n}: checkpoint shape "
                           f"{tuple(flat[n].shape)} != {tuple(t.shape)}")
        t.copy_(flat[n])


def load_checkpoint_state(train_state, names, restored, chrono: Chrono):
  """Puts a restored checkpoint into the live train state, in place."""
  _copy_named(names, train_state["params"], restored["params"], "params")
  if "ema_params" in train_state:
    _copy_named(names, train_state["ema_params"], restored["ema_params"],
                "ema_params")
  opt = restored["opt"]
  train_state["opt"]["count"] = int(opt["count"])
  _copy_named(names, train_state["opt"]["mu"], opt["mu"], "opt/mu")
  _copy_named(names, train_state["opt"]["nu"], opt["nu"], "opt/nu")
  train_state["generator"].set_state(restored["generator"]["state"])
  chrono.load(restored["chrono"]["accum_train_time"])


def train_and_evaluate(config: dict, workdir: Optional[str] = None,
                       device="cuda", log=print) -> tuple:
  """Runs the training loop on one device; returns (train_state, history).

  With a `workdir` the run writes `sv_tpu_metrics.txt` and `config.json`
  there, checkpoints every `ckpt_steps` under `checkpoints/` (a finetune
  run under `finetune/checkpoints/`), resumes from the newest checkpoint
  when one is there (parameters, EMA, optimizer, the generator's state and
  the position in the data stream, so that a resumed run computes what an
  uninterrupted one would), and writes the evaluators' image grids (.npy)
  and samples (.npz). `config["model_init"]` warm-starts from a flat npz;
  `config["finetune"]` / `config["resume"]` take parameters (and EMA) from a
  pretrain checkpoint and keep a fresh label head and optimizer.

  history has one entry per step run here, {"step", "ms"} (host clock
  around the step, which ends in a device synchronisation), plus
  "training_loss", the l2 norms and "epochs" on log steps. Raises when the
  loss is not finite on a log step. With `force_eval` the evaluators run
  once and the function returns with an empty history.

  The JAX loop's `profile_flops` (XLA's cost analysis) and `profile`
  (`jax.profiler`) have no counterpart here: `tools/profile_train.py`
  traces a step with torch.profiler.
  """
  chrono = Chrono(device=device)
  mw = MetricWriter(workdir, config)
  run = setup_training(config, device, log)
  total_steps, batch_size = run["total_steps"], run["batch_size"]
  ntrain_img, get_steps = run["ntrain_img"], run["get_steps"]
  train_state, update_fn = run["train_state"], run["update_fn"]
  model, names, opt = run["model"], run["names"], run["opt"]
  note = lambda s: log(f"NOTE: {s}")
  chrono.inform(total_steps=total_steps, global_bs=batch_size,
                steps_per_epoch=ntrain_img / batch_size,
                measure=mw.measure, write_note=note)
  mw.measure("num_params", sum(p.numel() for p in train_state["params"]))

  def reset_ema():
    if "ema_params" in train_state:
      with torch.no_grad():
        for e, p in zip(train_state["ema_params"], train_state["params"]):
          e.copy_(p)

  if config.get("model_init"):
    # Warm start from a flat-npz zoo checkpoint.
    merged = merge_params(
        ckpt_lib.load_params_npz(config["model_init"]),
        _named(names, train_state["params"]),
        dont_load=tuple(config.get("model_load", {}).get("dont_load", ())))
    _copy_named(names, train_state["params"], merged, "model_init")
    reset_ema()

  # Checkpoint resume. A finetune run writes to its own subdirectory; on
  # its first start it performs "surgery" on the pretrain checkpoint: fresh
  # label embedder/trunk + fresh optimizer.
  ckpt_dir = workdir
  if workdir and config.get("finetune"):
    ckpt_dir = os.path.join(workdir, "finetune")
  ckpt_mngr = None
  if ckpt_dir and (config.get("save_ckpt", True) or config.get("resume")):
    ckpt_mngr = ckpt_lib.make_manager(
        ckpt_dir, keep_period=get_steps("keep_ckpt", None))
    restored = ckpt_lib.restore(ckpt_mngr)
    if restored is not None:
      note(f"Resumed from step {ckpt_mngr.latest_step()}")
      load_checkpoint_state(train_state, names, restored, chrono)
    elif config.get("finetune") or config.get("resume"):
      src_dir = config.get("resume") or workdir
      src_mngr = (ckpt_lib.make_manager(src_dir)
                  if src_dir != ckpt_dir else ckpt_mngr)
      if src_mngr.latest_step() is not None:
        note(f"Finetune surgery from {src_dir} step {src_mngr.latest_step()}")
        _copy_named(names, train_state["params"],
                    ckpt_lib.restore_subtree(src_mngr, "params"), "params",
                    skip=("label_embed", "label_trunk"))
        reset_ema()
        train_state["opt"] = opt.init(train_state["params"])

  eval_fns = make_eval_fns(model, config)
  evaluators = []
  if config.get("evals"):
    from small_vision_tpu_torch.evaluators import common as eval_common
    evaluators = eval_common.from_config(
        config, eval_fns, device,
        lambda key, cfg: steps(key, cfg, ntrain_img, batch_size, total_steps,
                               default=None))

  def handle_eval_results(name, prefix, results, step):
    """Logs an evaluator's outputs; `fid_samples` are dumped as .npz and
    image tensors as .npy grids under the workdir."""
    for key, value in results:
      if key == "fid_samples":
        if config.get("inception_reference_path"):
          raise NotImplementedError(
              "inception_reference_path is set, but FID scoring "
              "(evaluators/fid.py, inception.py) comes with the evaluators "
              "slice; unset it to save the samples unscored")
        if workdir:
          out_dir = os.path.join(workdir, f"{name}_samples")
          os.makedirs(out_dir, exist_ok=True)
          ys = value["ys"]
          np.savez(os.path.join(out_dir, f"samples_{step}.npz"),
                   samples=value["samples"],
                   ys=ys if ys is not None else np.zeros(0))
      elif key.startswith("image"):
        if workdir:
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
      handle_eval_results(name, prefix, evaluator.run(train_state),
                          first_step)
    mw.step_end()
    if config.get("force_eval"):
      mw.close()
      return train_state, []

  log_steps = run["log_steps"]
  ckpt_steps = get_steps("ckpt", None)
  # Deterministic data resume: the stream continues where the stopped run's
  # step count left it.
  batches = run["batches_from"](first_step)
  sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
          else lambda: None)
  history = []
  for step in range(first_step + 1, total_steps + 1):
    batch = next(batches)
    mw.step_start(step)
    log_now = itstime(step, log_steps, total_steps)
    t0 = time.perf_counter()
    measurements = update_fn(train_state, batch, with_l2=log_now)
    sync()
    entry = {"step": step, "ms": (time.perf_counter() - t0) * 1e3}
    if log_now:
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
        ckpt_lib.save(ckpt_mngr, checkpoint_state(train_state, names, chrono),
                      step)
      chrono.resume()

    for (name, evaluator, ev_steps, prefix) in evaluators:
      if itstime(step, ev_steps, total_steps, first=False, last=True):
        chrono.pause(wait_for=train_state["params"])
        chrono.tick(step)
        note(f"{name} evaluation at step {step}...")
        with torch.profiler.record_function("evaluator"):
          handle_eval_results(name, prefix, evaluator.run(train_state), step)
        chrono.resume()

    mw.step_end()

  if ckpt_mngr:
    ckpt_lib.wait_until_finished(ckpt_mngr)
  mw.close()
  return train_state, history
