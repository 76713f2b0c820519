"""The processes of tests/test_torch_parallel_multiproc.py (no tests here).

`run(rank, n, device, tmp)` is started in 4 gloo processes by
`tools.dryrun_multichip.spawn`; it reads the plan the parent wrote to
`tmp` (weights, batches, draws), runs each scenario and writes what the
parent checks to `tmp/out/<scenario>_rank<r>.npz`. It imports torch and
the port only (no JAX), so that the processes start quickly.
"""

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from small_vision_tpu_torch import optim
from small_vision_tpu_torch.data import core as ds_core
from small_vision_tpu_torch.evaluators import mean as mean_eval
from small_vision_tpu_torch.models import ae
from small_vision_tpu_torch.ops import diffusion as gd_lib
from small_vision_tpu_torch.parallel import collectives as c
from small_vision_tpu_torch.parallel import ctx, explicit_step
from small_vision_tpu_torch.parallel import mesh as mesh_lib
from small_vision_tpu_torch.parallel import pipeline as pl
from small_vision_tpu_torch.parallel import sharding
from small_vision_tpu_torch.train import train_ae
from small_vision_tpu_torch.utils import checkpoint as ckpt_lib

# Shared with the parent.
EXPLICIT_TINY = dict(width=64, depth=2, dec_depth=1, num_heads=4,
                     img_size=16, patch_size=(4, 4), dtype_mm="float32",
                     scan=False, adaln=True, attn_impl="xla")
EXPLICIT_CASES = {"dp": (dict(), "dp", None),
                  "zero3_data2_fsdp2": (dict(data=2, fsdp=2), "zero3", None),
                  "zero3_fsdp4_clip": (dict(fsdp=4), "zero3", 0.05)}
TRAIN_CASES = {"replicated": dict(),
               "fully_sharded": dict(param_sharding="fully_sharded",
                                     optim_sharding="fully_sharded",
                                     mesh_fsdp=0, min_size_to_shard=0),
               "data2_fsdp2": dict(param_sharding="fully_sharded",
                                   optim_sharding="fully_sharded",
                                   mesh_fsdp=2, min_size_to_shard=0),
               # ZeRO-1: replicated parameters, sharded optimizer state.
               "zero1": dict(optim_sharding="fully_sharded", mesh_fsdp=0,
                             min_size_to_shard=0),
               # Sharded parameters; the optimizer state's default, as in
               # JAX, is replicated.
               "sharded_params": dict(param_sharding="fully_sharded",
                                      mesh_fsdp=0, min_size_to_shard=0)}
_ORIG_MAKE_UPDATE = train_ae.make_update_fn
PIPE_MODEL = dict(width=32, depth=4, dec_depth=2, num_heads=4, img_size=16,
                  patch_size=(4, 4), scan=True, adaln=True,
                  dtype_mm="float32", attn_impl="pallas")


def tanh_block(lp, x):
  """The JAX pipeline tests' residual tanh MLP block."""
  return x + torch.tanh(x @ lp["w"] + lp["b"]) @ lp["v"]


def sequential(stacked, x):
  for i in range(stacked["w"].shape[0]):
    x = tanh_block({k: v[i] for k, v in stacked.items()}, x)
  return x


def explicit_opt(names, lr_peak=1e-3):
  """The port's AdamW with the settings the parent gives JAX (clip off:
  the explicit step takes `grad_clip_norm`)."""
  return optim.AdamW(names, peak_lr=lr_peak * 256 / 16, batch_size=16,
                     total_steps=10, warmup_steps=1, wd=0.05,
                     clip_norm=1e9, mu_dtype="float32")


def _save(tmp, name, rank, **arrays):
  os.makedirs(os.path.join(tmp, "out"), exist_ok=True)
  np.savez(os.path.join(tmp, "out", f"{name}_rank{rank}.npz"), **{
      k: (v.detach().cpu().float().numpy() if isinstance(v, torch.Tensor)
          and v.dtype == torch.bfloat16 else v.detach().cpu().numpy()
          if isinstance(v, torch.Tensor) else np.asarray(v))
      for k, v in arrays.items()})


def collectives_scenario(rank, n, tmp):
  mine = np.full((2, 3), rank, np.float32)
  # The differentiable gather (backward: reduce-scatter) and scatter
  # (backward: all-gather) on the world, against their sums by hand.
  world = dist.group.WORLD
  w = torch.arange(2.0 * n * 3).reshape(2 * n, 3)
  x = torch.from_numpy(mine).requires_grad_(True)
  (g_gather,) = torch.autograd.grad((c.gather(x, world, 0) * w).sum(), x)
  y = torch.arange(2.0 * n * 3).reshape(2 * n, 3).requires_grad_(True)
  part = c.scatter(y, world, 0)
  (g_scatter,) = torch.autograd.grad((part * (rank + 1)).sum(), y)
  _save(tmp, "collectives", rank, g_gather=g_gather, part=part,
        g_scatter=g_scatter,
        tiled=c.process_allgather(mine),
        stacked=c.process_allgather(mine, tiled=False),
        fetched=c.fetch_global({"a": mine + 10, "b": None})["a"],
        bcast=c.broadcast_one_to_all(np.arange(3.0) + rank),
        metric=c.gather_metrics(np.array([rank, rank + 0.5])),
        summed=c.all_reduce_host([rank, 1.0]))


def eval_scenario(rank, n, tmp):
  """The `mean` evaluator over 41 (11/10/10/10) and 3 (1/1/1/0) examples."""
  for total in (41, 3):
    ev = mean_eval.Evaluator(
        lambda _, batch: {"m": batch["image"].float().mean((1, 2, 3)),
                          "lab": batch["label"].float()},
        device="cpu", batch_size=8, pp_fn="value_range(-1, 1)",
        data=dict(name="synthetic", split="validation", img_size=8,
                  num_examples=total, pool=64))
    start, stop = ds_core.even_split_range(total)
    got = dict(ev.run(None))
    _save(tmp, f"eval{total}", rank, steps=ev.n_steps, shard=stop - start,
          **got)


def explicit_scenario(rank, n, tmp):
  plan = np.load(os.path.join(tmp, "explicit_plan.npz"))
  for case, (kw, strategy, clip) in EXPLICIT_CASES.items():
    mesh = mesh_lib.make_mesh(**kw)
    model = ae.Model(**EXPLICIT_TINY).train()
    model.load_state_dict({k: torch.from_numpy(plan[f"p/{k}"])
                           for k in model.state_dict()})
    names = sorted(n.replace(".", "/") for n, _ in model.named_parameters())
    update = explicit_step.make_explicit_update_fn(
        model, explicit_opt(names), mesh, strategy=strategy,
        min_size_to_shard=1024, grad_clip_norm=clip)
    state = update.place(gd_lib.GaussianDiffusion.create("cosine", 50,
                                                         device="cpu"))
    index, count = mesh.batch_shard()
    rows = slice(index * 16 // count, (index + 1) * 16 // count)
    losses = []
    for step in range(2):
      batch = {k: torch.from_numpy(plan[f"{k}{step}"][rows])
               for k in ("image", "t", "noise")}
      state, loss = update(state, batch)
      losses.append(float(loss))
    full = update.layout.full(state["params"])
    sharded = sum(a is not None for a in update.layout._axis)
    _save(tmp, f"explicit_{case}", rank, losses=losses, sharded=sharded,
          **{f"p/{k}": t for k, t in zip(names, full)})


def pipeline_scenario(rank, n, tmp):
  plan = np.load(os.path.join(tmp, "pipe_plan.npz"))
  mesh = mesh_lib.make_mesh(data=2, pipe=2)
  index, count = mesh.batch_shard()
  stacked = {k: torch.from_numpy(plan[k]) for k in ("w", "b", "v")}
  rows = slice(index * 16 // count, (index + 1) * 16 // count)
  x = torch.from_numpy(plan["x"][rows]).requires_grad_(True)
  tgt = torch.from_numpy(plan["tgt"][rows])
  data_group = mesh.group("data")
  for api in ("staged", "stacked"):
    if api == "staged":
      params = sharding.reshard(pl.stage_params(stacked, 2), ("pipe",), mesh)
      params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
      out = pl.pipeline_apply(tanh_block, params, x, mesh=mesh,
                              n_microbatches=4, batch_axes=("data",))
    else:
      params = sharding.reshard(stacked, ("pipe",), mesh)
      params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
      out = pl.pipeline_apply_stacked(tanh_block, params, x, mesh=mesh,
                                      n_microbatches=4, batch_axes=("data",))
    # The global mean-square loss: this process's share of the sum.
    loss = torch.sum((out - tgt) ** 2) / (16 * tgt.shape[1])
    grads = torch.autograd.grad(loss, [x] + [params[k] for k in "wbv"])
    g_params = [c.all_reduce(g.clone(), data_group) for g in grads[1:]]
    _save(tmp, f"pipe_{api}", rank, out=out, gx=grads[0], rows=[rows.start],
          stage=mesh.coord("pipe"),
          **{f"g{k}": g for k, g in zip("wbv", g_params)})

  # The model's pipe_stages=2 on data=2 x pipe=2 against scan=True.
  model = ae.Model(**PIPE_MODEL, pipe_stages=2, pipe_microbatches=2).train()
  model.load_state_dict({k: torch.from_numpy(plan[f"m/{k}"])
                         for k in model.state_dict()})
  rows = slice(index * 8 // count, (index + 1) * 8 // count)
  img = torch.from_numpy(plan["img"][rows])
  t = torch.from_numpy(plan["t"][rows])
  with ctx.activate_mesh(mesh):
    pred, _ = model(img, t=t)
    loss = torch.sum(pred ** 2) / (8 * pred[0].numel())
    named = sorted(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True, materialize_grads=True)
  world = dist.group.WORLD
  out = {}
  for (name, _), g in zip(named, grads):
    # A stack's gradient is its stage's slice (zeros elsewhere): summed
    # over every process; a replicated leaf's is whole on each stage.
    out[f"g/{name}"] = c.all_reduce(
        g.clone(), world if ".blocks." in name else data_group)
  _save(tmp, "pipe_model", rank, pred=pred, rows=[rows.start], **out)


class Stop(Exception):
  """Raised by the patched step at step 4: the test stops the run there."""


def _patched_update(plan, index, count, record, stop_at=3):
  """make_update_fn with the plan's batch (this process's rows: its share
  of the diffusion rows, then of the MAE rows) and draws, and no device
  pp. `record` keeps the train state and each step's measurements (whose
  loss the loop then averages over the processes, in place); the call
  after `stop_at` steps waits for the checkpoint writer and raises `Stop`,
  so that a run of a longer schedule ends after `stop_at` steps."""
  import threading

  def make(model, opt, config, device_pp, **kw):
    update = _ORIG_MAKE_UPDATE(model, opt, config, None, **kw)
    b = int(plan["image0"].shape[0])
    n_noise = b - int(b * config["no_noise_prob"])
    nl, ml = n_noise // count, (b - n_noise) // count

    def update_fn(train_state, batch, draws=None, *, with_l2=False):
      s = len(record.setdefault("meas", []))
      if s == stop_at:
        for th in threading.enumerate():
          if th.name == ckpt_lib.WRITER_THREAD:
            th.join()
        raise Stop()
      img = plan[f"image{s}"]
      rows = np.r_[index * nl:(index + 1) * nl,
                   n_noise + index * ml:n_noise + (index + 1) * ml]
      draws = {}
      for k, per in (("t", nl), ("noise", nl), ("dit_noise", nl),
                     ("mae_noise", ml)):
        draws[k] = plan[f"{k}{s}"][index * per:(index + 1) * per]
      meas = update(train_state, {"image": img[rows]}, draws,
                    with_l2=with_l2)
      record["meas"].append(meas)
      record["state"] = train_state
      return meas
    return update_fn
  return make


def train_steps(config, workdir, plan, mesh=None):
  """3 steps of `train_and_evaluate` on the plan; (losses, train state)."""
  index, count = mesh.batch_shard() if mesh else (0, 1)
  record = {}
  train_ae.make_update_fn = _patched_update(plan, index, count, record)
  try:
    train_ae.train_and_evaluate(config, workdir, device="cpu",
                                log=lambda s: None, mesh=mesh)
    raise AssertionError("the run did not stop at step 4")
  except Stop:
    pass
  finally:
    train_ae.make_update_fn = _ORIG_MAKE_UPDATE
  return [float(m["training_loss"]) for m in record["meas"]], record["state"]


def training_config(tmp, case):
  with open(os.path.join(tmp, "train_config.json")) as f:
    config = json.load(f)
  config.update(TRAIN_CASES[case])
  return config


def train_scenario(rank, n, tmp):
  plan = np.load(os.path.join(tmp, "train_plan.npz"))
  for case in TRAIN_CASES:
    config = training_config(tmp, case)
    mesh = train_ae.build_mesh(config)
    losses, state = train_steps(config, os.path.join(tmp, f"work_{case}"),
                                plan, mesh)
    names = [nm for nm, _ in train_ae.named_params(
        train_ae.build_model(config, device="meta"))]
    layout = _layout_of(config, mesh)
    full = layout.full(state["params"])
    _save(tmp, f"train_{case}", rank, losses=losses,
          local=sum(int(t.numel()) for t in state["params"]),
          opt_local=sum(int(t.numel()) for t in state["opt"]["mu"]),
          state_bytes=_state_bytes(state),
          **{f"p/{k}": t for k, t in zip(names, full)},
          **{f"nu/{k}": t for k, t in zip(names, layout.full(
              state["opt"]["nu"], opt=True))})


def _state_bytes(state):
  """Bytes of this process's parameters, EMA and optimizer state."""
  tensors = list(state["params"]) + list(state.get("ema_params", ())) + (
      list(state["opt"]["mu"]) + list(state["opt"]["nu"]))
  return sum(t.numel() * t.element_size() for t in tensors)


def _layout_of(config, mesh):
  """The layout the trainer used, rebuilt from the config (for `full`)."""
  model = train_ae.build_model(config, device="meta")
  return train_ae.make_layout(config, mesh, train_ae.named_params(model))


def restore_scenario(rank, n, tmp):
  """The single process's step-3 checkpoint restored into fsdp=4: every
  process's parts, put together, are the checkpoint's tensors."""
  config = training_config(tmp, "fully_sharded")
  mesh = train_ae.build_mesh(config)
  run = train_ae.setup_training(config, "cpu", lambda s: None, mesh)
  mngr = ckpt_lib.make_manager(os.path.join(tmp, "work_single"),
                               writer=False)
  restored = ckpt_lib.restore(mngr)
  from small_vision_tpu_torch.utils.chrono import Chrono
  train_ae.load_checkpoint_state(run["train_state"], run["names"], restored,
                                 Chrono(), run["layout"])
  lay = run["layout"]
  state = run["train_state"]
  _save(tmp, "restore", rank, **{
      f"{what}/{k}": t for what, ts in (
          ("params", lay.full(state["params"])),
          ("mu", lay.full(state["opt"]["mu"], opt=True)),
          ("nu", lay.full(state["opt"]["nu"], opt=True)))
      for k, t in zip(run["names"], ts)},
        count=state["opt"]["count"],
        local=sum(int(t.numel()) for t in state["params"]))


def vae_scenario(rank, n, tmp):
  """A latent step's loss with a seeded VAE (channels 32 x 4, as
  tests/test_torch_latent.py's) replicated and sharded over fsdp 4
  (`vae_param_sharding`): the encode gathers the VAE, so the two losses
  are equal; the checkpoint holds the whole VAE."""
  import functools
  from small_vision_tpu_torch.models import vae as vae_lib
  from small_vision_tpu_torch.utils.chrono import Chrono
  load_vae = vae_lib.load_vae
  vae_lib.load_vae = functools.partial(load_vae,
                                       block_out_channels=(32, 32, 32, 32))
  rng = np.random.default_rng(5)
  images = torch.from_numpy(rng.uniform(-1, 1, (4, 32, 32, 3)).astype(
      np.float32))
  draws = {"t": torch.tensor([3, 500]),
           "noise": torch.from_numpy(rng.standard_normal(
               (2, 4, 4, 4)).astype(np.float32)),
           "vae_noise": torch.from_numpy(rng.standard_normal(
               (4, 4, 4, 4)).astype(np.float32)),
           "mae_noise": torch.from_numpy(rng.random((2, 16), np.float32)),
           "dit_noise": torch.from_numpy(rng.random((2, 16), np.float32))}
  out = {}
  try:
    _vae_runs(images, draws, out, Chrono)
  finally:
    vae_lib.load_vae = load_vae
  _save(tmp, "vae", rank, **out)


def _vae_runs(images, draws, out, chrono):
  from small_vision_tpu_torch.configs import ae_i1k
  for placement in ("replicated", "fully_sharded"):
    config = ae_i1k.get_config("runlocal,data=synthetic,total_steps=2")
    config.update(latent_diffusion=True, size=32, diffusion_space=(4, 4, 4),
                  vae_param_sharding=placement, mesh_fsdp=0,
                  min_size_to_shard=0)
    config["model"].update(img_size=4, patch_size=(1, 1), channels=4,
                           dtype_mm="float32", attn_impl="xla")
    config["input"].update(batch_size=4, num_workers=1,
                           pp='keep("image", "label")')
    config["input"]["data"].update(img_size=32, num_examples=16)
    mesh = train_ae.build_mesh(config)
    run = train_ae.setup_training(config, "cpu", lambda s: None, mesh)
    loss, _ = run["update_fn"].loss_and_grads(run["train_state"],
                                              {"image": images}, draws)
    out[f"loss_{placement}"] = loss
    out[f"local_{placement}"] = sum(
        t.numel() for t in run["train_state"]["vae_params"].values())
    state = train_ae.checkpoint_state(run["train_state"], run["names"],
                                      chrono(), run["layout"])
    out[f"ckpt_{placement}"] = sum(
        float(t.double().sum()) for t in state["vae_params"].values())
    if placement == "replicated":  # the whole seeded VAE
      full = run["train_state"]["vae_params"].values()
      out["full_sum"] = sum(float(t.double().sum()) for t in full)
      out["full_count"] = sum(t.numel() for t in full)


def run(rank, n, device, tmp):
  collectives_scenario(rank, n, tmp)
  vae_scenario(rank, n, tmp)
  eval_scenario(rank, n, tmp)
  explicit_scenario(rank, n, tmp)
  pipeline_scenario(rank, n, tmp)
  train_scenario(rank, n, tmp)
  restore_scenario(rank, n, tmp)
  from small_vision_tpu_torch.tools import dryrun_multichip
  dryrun_multichip.dryrun(rank, n, device)


def hang(rank, n, device):
  """Never ends: `spawn` must kill it at its time limit."""
  import time
  time.sleep(3600)
