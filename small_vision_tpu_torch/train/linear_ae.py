"""The linear-probe trainer: frozen UMD features → BatchNorm + Dense head.

Counterpart of small_vision_tpu/train/linear_ae.py: `LinearCLS` (an
affine-free BatchNorm, then Dense), the frozen backbone loaded from a
pretrain checkpoint's `params` (or seeded when no `pretrain_workdir` is
given), LARS at `peak_lr · bs/256` on a warmup-cosine schedule
(`optim.LarsProbe`), the representation at t=0 or, with `use_noised_pred`,
of the input noised to t=50, the head alone trained (the backbone runs
without gradients), the probe's own checkpoint under `{workdir}/probe`
with its resume, and the classification evaluators on the head's logits.

The BatchNorm is flax's, written as a function (`batch_norm`): in training
the batch's mean and biased variance (E[x²] − E[x]², clipped at 0, as flax
0.12 takes it) normalise the batch, and the running statistics move as
`0.9 · running + 0.1 · batch`. `nn.BatchNorm1d` keeps the unbiased
variance in its running statistics, which is another function.

The step's random draws (the device pp's and, with `use_noised_pred`, the
noise of the t=50 input) come from the train state's `torch.Generator`.
As in the JAX trainer, the LARS weight decay is 0 whatever the config's
`wd`.
"""

import math
import os
import time
from typing import Optional

import numpy as np
import torch

from small_vision_tpu_torch import convert, optim
from small_vision_tpu_torch.data import pipeline
from small_vision_tpu_torch.models.common import dense, lecun_normal
from small_vision_tpu_torch.ops import diffusion as gd_lib
from small_vision_tpu_torch.train import train_ae
from small_vision_tpu_torch.utils import checkpoint as ckpt_lib
from small_vision_tpu_torch.utils.chrono import Chrono
from small_vision_tpu_torch.utils.metrics import MetricWriter
from small_vision_tpu_torch.utils.misc import itstime
from small_vision_tpu_torch.utils.schedules import steps

NOISED_T = 50  # the noised probe's timestep (the model sees t + 1)
HEAD_NAMES = ("Dense_0/kernel", "Dense_0/bias")  # flax's, sorted


def batch_norm(x, stats, train: bool, momentum: float = 0.9,
               eps: float = 1e-5):
  """flax nn.BatchNorm(use_scale=False, use_bias=False) over axis 0:
  (y, new stats). `stats` is {"mean", "var"}; with `train` the batch's
  statistics normalise and the running ones move, else the running ones
  normalise and stay."""
  x = x.float()
  if train:
    mean = x.mean(0)
    var = torch.clamp((x * x).mean(0) - mean * mean, min=0.0)
    stats = {"mean": momentum * stats["mean"] + (1 - momentum) * mean,
             "var": momentum * stats["var"] + (1 - momentum) * var}
  else:
    mean, var = stats["mean"], stats["var"]
  return (x - mean) * torch.rsqrt(var + eps), stats


def linear_cls(params, stats, rep, train: bool):
  """LinearCLS: (logits, new stats) of the head {"kernel", "bias"}."""
  y, stats = batch_norm(rep, stats, train)
  return dense(y, params[0], params[1], None), stats


def init_head(width: int, num_classes: int, seed: int = 1, device="cuda"):
  """[kernel (width, classes), bias]: flax Dense's lecun-normal kernel (a
  normal truncated to ±2, scaled to variance 1/width) and zero bias, drawn
  from `seed` on the CPU; and the BatchNorm's statistics, zeros and
  ones."""
  kernel = lecun_normal((width, num_classes), width,
                        torch.Generator().manual_seed(seed))
  params = [kernel.to(device), torch.zeros(num_classes, device=device)]
  stats = {"mean": torch.zeros(width, device=device),
           "var": torch.ones(width, device=device)}
  return params, stats


def load_frozen_backbone(config: dict, pretrain_workdir: Optional[str],
                         device="cuda") -> torch.nn.Module:
  """The UMD of `config["model"]`, without gradients: the `params` of the
  newest checkpoint under `pretrain_workdir` (a `train_ae` run's, in
  either block layout: a `scan=True` run's stacked blocks load into an
  unrolled backbone and the reverse), or the seeded training init
  (`convert.init_train_params`, seed 0) without one."""
  model = train_ae.build_model(config, device=device)
  if pretrain_workdir:
    mngr = ckpt_lib.make_manager(pretrain_workdir)
    if mngr.latest_step() is None:
      raise FileNotFoundError(f"no checkpoint under {pretrain_workdir}")
    names = [n for n, _ in train_ae.named_params(model)]
    tensors = [p for _, p in train_ae.named_params(model)]
    restored = convert.to_layout(ckpt_lib.restore_subtree(mngr, "params"),
                                 names)
    train_ae._copy_named(names, tensors, restored, "params")
  else:
    model.load_state_dict(convert.params_from_jax(
        convert.init_train_params(config, 0), model))
  return model


def make_fns(model, config: dict, device_pp, opt: optim.LarsProbe):
  """(update_fn, eval_logits_fn, backbone_rep) of the probe.

  `update_fn(train_state, batch) -> measurements`: updates the head, its
  optimizer state and the BatchNorm statistics in place; its draws (the
  device pp's, then the noise with `use_noised_pred`) come from the train
  state's generator. `eval_logits_fn(train_state, batch, generator=None)
  -> (logits, {})`: the running statistics, the noise from `generator`,
  by default a copy of the train state's."""
  use_noised = bool(config.get("use_noised_pred", False))
  num_classes = int(config.get("num_classes", 1000))
  device = next(model.parameters()).device

  @torch.no_grad()
  def backbone_rep(train_state, images, noise=None):
    """pre_logits of the frozen forward at t=0, or at t=50 noised."""
    b = images.shape[0]
    if use_noised:
      t = torch.full((b,), NOISED_T, dtype=torch.long, device=images.device)
      images = gd_lib.q_sample(train_state["gd"], images, t, noise)
      t_in = t + 1
    else:
      t_in = torch.zeros((b,), dtype=torch.long, device=images.device)
    _, out = model(images, t=t_in)
    return out["pre_logits"].float()

  def draw_noise(images, gen):
    if not use_noised:
      return None
    return torch.randn(images.shape, generator=gen, device=images.device)

  def labels_of(batch):
    labels = batch["labels"] if "labels" in batch else batch["label"]
    if labels.ndim == 1:
      labels = torch.nn.functional.one_hot(labels.long(), num_classes)
    return labels.float()

  def update_fn(train_state, batch):
    batch = {k: torch.as_tensor(v).to(device, non_blocking=True)
             for k, v in batch.items()}
    gen = train_state["generator"]
    if device_pp is not None:
      batch = device_pp(batch, device_pp.draw(batch["image"].shape[0], gen,
                                              device))
    images = batch["image"]
    rep = backbone_rep(train_state, images, draw_noise(images, gen))
    labels = labels_of(batch)
    head = [p.detach().requires_grad_() for p in train_state["params"]]
    logits, stats = linear_cls(head, train_state["batch_stats"], rep,
                               train=True)
    loss = -(labels * torch.log_softmax(logits, dim=-1)).sum(-1).mean()
    grads = torch.autograd.grad(loss, head)
    with torch.no_grad():
      acc = (logits.argmax(-1) == labels.argmax(-1)).float().mean()
      opt.step(train_state["params"], grads, train_state["opt"])
      train_state["batch_stats"] = {k: v.detach() for k, v in stats.items()}
    return {"training_loss": loss.detach(), "training_accuracy": acc}

  @torch.no_grad()
  def eval_logits_fn(train_state, batch, generator=None):
    images = batch["image"]
    noise = draw_noise(images, generator or train_ae.eval_generator(
        train_state)) if use_noised else None
    rep = backbone_rep(train_state, images, noise)
    logits, _ = linear_cls(train_state["params"], train_state["batch_stats"],
                           rep, train=False)
    return logits, {}

  return update_fn, eval_logits_fn, backbone_rep


def probe_state(train_state) -> dict:
  """The probe's checkpoint: the head, LARS's count and trace, the
  BatchNorm statistics and the generator. The frozen backbone is not in
  it: it reloads from the pretrain checkpoint."""
  named = lambda tensors, names: dict(zip(names, tensors))
  opt = train_state["opt"]
  return {
      "params": named(train_state["params"], HEAD_NAMES),
      "opt": {"count": np.int64(opt["count"]),
              **named(opt["trace"], [f"trace/{n}" for n in HEAD_NAMES])},
      "batch_stats": {"bn/mean": train_state["batch_stats"]["mean"],
                      "bn/var": train_state["batch_stats"]["var"]},
      "generator": {"state": train_state["generator"].get_state()},
  }


def load_probe_state(train_state, restored):
  """Puts a restored probe checkpoint into the live train state."""
  copy = train_ae._copy_named
  copy(list(HEAD_NAMES), train_state["params"], restored["params"], "params")
  opt = restored["opt"]
  train_state["opt"]["count"] = int(opt["count"])
  copy(list(HEAD_NAMES), train_state["opt"]["trace"], opt["trace"],
       "opt/trace")
  stats = restored["batch_stats"]["bn"]
  device = train_state["params"][0].device
  train_state["batch_stats"] = {k: stats[k].to(device) for k in ("mean",
                                                                 "var")}
  train_state["generator"].set_state(restored["generator"]["state"])


def train_and_evaluate(config: dict, workdir: Optional[str] = None,
                       device="cuda", log=print) -> tuple:
  """Trains the probe on one device; returns (train_state, history).

  With a `workdir` the run writes its metrics there and checkpoints the
  probe every `ckpt_steps` (and at the end) under `{workdir}/probe`; a
  second start on the same workdir resumes from the newest one, the data
  stream included. history has one entry per step run here: {"step",
  "ms"} and, on log steps, "training_loss" and "training_accuracy". The
  evaluators (`classification` on `predict`, the head's logits) run at
  their `log_steps` and at the last step; their metrics are logged and
  kept under "evals". Raises when the loss is not finite on a log step.
  """
  chrono = Chrono(device=device)
  mw = MetricWriter(workdir, config)
  note = lambda s: log(f"NOTE: {s}")
  batch_size = int(config["input"]["batch_size"])
  train_iter, device_pp, ntrain_img = pipeline.training(config["input"],
                                                        device)
  total_steps = steps("total", config, ntrain_img, batch_size)
  chrono.inform(total_steps=total_steps, global_bs=batch_size,
                steps_per_epoch=ntrain_img / batch_size,
                measure=mw.measure, write_note=note)

  model = load_frozen_backbone(config, config.get("pretrain_workdir"),
                               device)
  width = int(config.get("width", model.width))
  num_classes = int(config.get("num_classes", 1000))
  total_epochs = config.get("total_epochs")
  if total_epochs:
    warmup_steps = max(int(0.05 * total_epochs) * ntrain_img // batch_size,
                       1)
  else:  # step-denominated config (runlocal): 5 % of the run
    warmup_steps = max(total_steps // 20, 1)
  opt = optim.LarsProbe(base_lr=float(config.get("peak_lr", 0.1)),
                        batch_size=batch_size, total_steps=total_steps,
                        warmup_steps=warmup_steps)
  head, stats = init_head(width, num_classes, seed=1, device=device)
  sched = config.get("diff_schedule", {})
  train_state = {
      "params": head, "opt": opt.init(head), "batch_stats": stats,
      "generator": torch.Generator(device=device).manual_seed(2),
      "gd": gd_lib.GaussianDiffusion.create(
          sched.get("beta_schedule", "cosine"),
          int(sched.get("timesteps", 1000)), device=device)}

  ckpt_mngr, start_step = None, 0
  if workdir and config.get("save_ckpt", True):
    ckpt_mngr = ckpt_lib.make_manager(os.path.join(workdir, "probe"))
    restored = ckpt_lib.restore(ckpt_mngr)
    if restored is not None:
      load_probe_state(train_state, restored)
      start_step = ckpt_mngr.latest_step()
      note(f"Probe resumed from step {start_step}")

  update_fn, eval_logits_fn, _ = make_fns(model, config, device_pp, opt)
  evaluators = []
  if config.get("evals"):
    from small_vision_tpu_torch.evaluators import common as eval_common
    evaluators = eval_common.from_config(
        config, {"predict": eval_logits_fn}, device,
        lambda key, cfg: steps(key, cfg, ntrain_img, batch_size, total_steps,
                               default=None))
  log_steps = steps("log_training", config, ntrain_img, batch_size,
                    total_steps, default=100)
  ckpt_steps = steps("ckpt", config, ntrain_img, batch_size, total_steps,
                     default=None)
  train_iter.start_step = start_step  # deterministic data resume
  batches = iter(train_iter)
  sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
          else lambda: None)
  history = []
  try:
    for step in range(start_step + 1, total_steps + 1):
      batch = next(batches)
      mw.step_start(step)
      t0 = time.perf_counter()
      measurements = update_fn(train_state, batch)
      sync()
      entry = {"step": step, "ms": (time.perf_counter() - t0) * 1e3}
      if itstime(step, log_steps, total_steps):
        measurements = {k: float(v) for k, v in measurements.items()}
        for name, value in measurements.items():
          mw.measure(name, value)
        chrono.tick(step)
        entry.update(measurements)
        log(f"probe step {step}/{total_steps}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in entry.items() if k != "step"))
        if not math.isfinite(entry["training_loss"]):
          raise RuntimeError("Probe loss became NaN/Inf")
      if ckpt_mngr and itstime(step, ckpt_steps, total_steps, first=False,
                               last=True):
        chrono.pause(wait_for=train_state["params"])
        ckpt_lib.save(ckpt_mngr, probe_state(train_state), step)
        chrono.resume()
      for (name, evaluator, ev_steps, prefix) in evaluators:
        if itstime(step, ev_steps, total_steps, first=False, last=True):
          entry.setdefault("evals", {})
          for key, value in evaluator.run(train_state):
            mw.measure(f"{prefix}{key}", value)
            entry["evals"][f"{prefix}{key}"] = value
      history.append(entry)
      mw.step_end()
  finally:
    batches.close()

  if ckpt_mngr:
    ckpt_lib.wait_until_finished(ckpt_mngr)
  mw.close()
  return train_state, history
