"""The UMD trainer: the model builder, the training step, a minimal train
loop, and the sampler functions.

Counterpart of small_vision_tpu/train/train_ae.py: `build_model`,
`mae_mix_weight`, `make_update_fn` (the joint MAE + diffusion step: device
pp, q_sample, the two branches, the loss mix, AdamW, EMA),
`train_and_evaluate` (synthetic data, init, N steps, loss logging, the NaN
abort) and, from `make_eval_fns`, the sampler suite (`make_apply_fn`,
`make_sample_fn`): uncond_eps, and with `num_classes` cond_eps, cfg_eps_*
and cfg_x0_*. Checkpointing, the evaluators, `Chrono` and the metric
writer come with later slices.

The step's random draws (t, noise, the two branches' mask noise, the flip
mask and the label-drop masks) come from the train state's
`torch.Generator`, or are injected, so that a test can drive the step with
the JAX package's draws.

A sampler function is `sample_fn(gd, generator, *, noise=None)`: the model
holds its (EMA) weights, `gd` the diffusion tables, `generator` draws the
noise and labels on the model's device, and `noise` optionally injects the
loop's draws (see `ops.diffusion.ddim_sample_loop`).
"""

import importlib
import math
import time
from typing import Optional

import numpy as np
import torch

from small_vision_tpu_torch import convert, optim
from small_vision_tpu_torch.data import synthetic
from small_vision_tpu_torch.ops import diffusion as gd_lib
from small_vision_tpu_torch.pp.builder import DevicePP
from small_vision_tpu_torch.utils.schedules import steps


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


def make_eval_fns(model, config: dict) -> dict:
  """The sampler functions the evaluators and the server consume."""
  dspace = tuple(config.get("diffusion_space", (64, 64, 3)))
  channels = int(dspace[-1])
  num_classes = config.get("num_classes", None)
  sched = config.get("diff_schedule", {})
  sampling_steps = int(sched.get("sampling_timesteps", 125))
  eta = float(sched.get("eta", 1.0))
  clip_denoised = bool(sched.get("clip_denoised", True))

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
    def sample_fn(gd, generator, *, noise=None):
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
    return sample_fn

  fns = {"uncond_eps": make_sample_fn()}
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


def itstime(step: int, every_n_steps: int, total_steps: int) -> bool:
  """True every `every_n_steps`, on the first and on the last step."""
  return bool(every_n_steps) and (step % every_n_steps == 0 or step == 1
                                  or step == total_steps)


def setup_training(config: dict, device="cuda", log=print) -> dict:
  """Everything a training run needs, from the config: the synthetic
  source's batches, the model with `init_train_params` weights, AdamW, the
  train state, the device pp and the step. Returns a dict of those and of
  `total_steps`, `batch_size` and `log_steps`."""
  in_cfg = dict(config["input"])
  batch_size = int(in_cfg["batch_size"])
  data_cfg = {k: v for k, v in in_cfg["data"].items() if k != "name"}
  source = synthetic.DataSource(**data_cfg)
  ntrain_img = source.total_examples
  total_steps = steps("total", config, ntrain_img, batch_size)
  warmup_steps = steps("warmup", config, ntrain_img, batch_size, total_steps,
                       None) or max(int(0.05 * total_steps), 1)
  log(f"{total_steps} steps ({total_steps * batch_size / ntrain_img:.3f} "
      f"epochs) at batch {batch_size} on {device}")

  model = build_model(config, device=device, trainable=True)
  model.load_state_dict(convert.params_from_jax(
      convert.init_train_params(config, int(config.get("seed", 0))), model))
  names = [n for n, _ in named_params(model)]
  opt = make_optimizer(config, names, total_steps, warmup_steps)
  train_state = init_train_state(model, opt, config, device)
  device_pp = DevicePP(in_cfg.get("pp", ""))
  return {
      "model": model, "opt": opt, "train_state": train_state,
      "update_fn": make_update_fn(model, opt, config, device_pp),
      "batches": synthetic.batches(source, batch_size,
                                   seed=int(config.get("seed", 0))),
      "total_steps": total_steps, "batch_size": batch_size,
      "log_steps": int(config.get("log_training_steps", 100)),
  }


def train_and_evaluate(config: dict, workdir: Optional[str] = None,
                       device="cuda", log=print) -> tuple:
  """Trains on the synthetic source for the config's steps.

  Returns (train_state, history): history has one entry per step,
  {"step", "ms"} (host clock around the step, which ends in a device
  synchronisation), plus "training_loss" and the l2 norms on log steps
  (every `log_training_steps`, the first and the last). Raises when the
  loss is not finite on a log step. `workdir` is accepted for the JAX
  package's signature; the port writes no checkpoints or metrics yet.
  """
  del workdir
  run = setup_training(config, device, log)
  total_steps, log_steps = run["total_steps"], run["log_steps"]
  train_state, update_fn = run["train_state"], run["update_fn"]
  sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
          else lambda: None)
  history = []
  for step in range(1, total_steps + 1):
    batch = next(run["batches"])
    log_now = itstime(step, log_steps, total_steps)
    t0 = time.perf_counter()
    measurements = update_fn(train_state, batch, with_l2=log_now)
    sync()
    entry = {"step": step, "ms": (time.perf_counter() - t0) * 1e3}
    if log_now:
      entry.update({k: float(v) for k, v in measurements.items()})
      log(f"step {step}/{total_steps}: " + ", ".join(
          f"{k} {v:.6g}" for k, v in entry.items() if k != "step"))
      if not math.isfinite(entry["training_loss"]):
        raise RuntimeError(f"Loss became NaN/Inf within steps "
                           f"[{step - log_steps}, {step}]")
    history.append(entry)
  return train_state, history
