"""The processes of tests/test_torch_tensor_parallel_multiproc.py (no tests
here).

`run(rank, n, device, tmp)` is started in 4 gloo processes by
`tools.dryrun_multichip.spawn`; it reads the plan the parent wrote to `tmp`
(the JAX step's batches and draws, test_torch_parallel_multiproc's), runs
3 steps of `train_and_evaluate` for each case of `TP_CASES` on a mesh with
a `tensor` axis of 2, restores the one-process run's checkpoint under
`tensor_parallel`, and writes what the parent checks to
`tmp/out/<scenario>_rank<r>.npz`. It imports torch and the port only.
"""

import json
import os

import numpy as np
from test_torch_parallel_worker import _layout_of, _save, _state_bytes
from test_torch_parallel_worker import train_steps

from small_vision_tpu_torch.parallel import ctx
from small_vision_tpu_torch.train import train_ae
from small_vision_tpu_torch.utils import checkpoint as ckpt_lib
from small_vision_tpu_torch.utils.chrono import Chrono

# Each case: (its placement, the settings it shares with the one-process
# run it is held to); a case with settings of its own has that run to
# itself (the parent's `one[case]`), the others share `one["base"]`.
_TP = dict(mesh_tensor=2, param_sharding="tensor_parallel")
_TP_FSDP = dict(mesh_fsdp=2, mesh_tensor=2, param_sharding="tp_fsdp",
                min_size_to_shard=0)
TP_CASES = {
    "tp_repl": (dict(_TP), {}),                           # data 2 x tensor 2
    "tp_tp": (dict(_TP, optim_sharding="tensor_parallel"),
              {"ema_decay": 0.25}),
    "tpfsdp_tpfsdp": (dict(_TP_FSDP, optim_sharding="tp_fsdp"), {}),
    "tpfsdp_repl": (dict(_TP_FSDP), {}),                  # fsdp 2 x tensor 2
    # The parameters over `tensor`, their optimizer state over `fsdp`.
    "tp_fsdpopt": (dict(_TP_FSDP, param_sharding="tensor_parallel",
                        optim_sharding="fully_sharded"), {}),
    "dropout": (dict(_TP), {"model": {"dropout": 0.1}}),
    "scan": (dict(_TP), {"model": {"scan": True},
                         "model_init": "init_scan.npz"}),
}
REFERENCE = [case for case, (_, own) in TP_CASES.items() if own]


def reference_config(base: dict, case: str) -> dict:
  """The one-process config a case is held to: the plan's with the
  case's own settings (under `scan=True` the stacked `model_init` the
  parent wrote beside the plan's)."""
  config = json.loads(json.dumps(base))
  own = dict(TP_CASES[case][1])
  config["model"].update(own.pop("model", {}))
  if "model_init" in own:
    config["model_init"] = os.path.join(os.path.dirname(
        config["model_init"]), own.pop("model_init"))
  config.update(own)
  return config


def case_config(base: dict, case: str) -> dict:
  return dict(reference_config(base, case), **TP_CASES[case][0])


def train_scenario(rank, tmp, base, plan):
  for case in TP_CASES:
    config = case_config(base, case)
    mesh = train_ae.build_mesh(config)
    # tp_repl's checkpoint is the one the parent restores; the others
    # write none.
    workdir = os.path.join(tmp, "work_tp_repl") if case == "tp_repl" else None
    losses, state = train_steps(config, workdir, plan, mesh)
    names = [nm for nm, _ in train_ae.named_params(
        train_ae.build_model(config, device="meta"))]
    layout = _layout_of(config, mesh)
    _save(tmp, f"tp_{case}", rank, losses=losses,
          local=sum(int(t.numel()) for t in state["params"]),
          opt_local=sum(int(t.numel()) for t in state["opt"]["mu"]),
          state_bytes=_state_bytes(state), mesh=json.dumps(mesh.shape),
          **{f"p/{k}": t for k, t in zip(names, layout.full(
              state["params"]))},
          **{f"nu/{k}": t for k, t in zip(names, layout.full(
              state["opt"]["nu"], opt=True))},
          **{f"ema/{k}": t for k, t in zip(names, layout.full(
              state.get("ema_params", [])))})


def restore_scenario(rank, tmp, base):
  """The one-process run's step-3 checkpoint restored under
  `tensor_parallel` (data 2 x tensor 2): each process's parts, gathered."""
  config = case_config(base, "tp_repl")
  mesh = train_ae.build_mesh(config)
  run = train_ae.setup_training(config, "cpu", lambda s: None, mesh)
  mngr = ckpt_lib.make_manager(os.path.join(tmp, "work_single"),
                               writer=False)
  train_ae.load_checkpoint_state(run["train_state"], run["names"],
                                 ckpt_lib.restore(mngr), Chrono(),
                                 run["layout"])
  lay, state = run["layout"], run["train_state"]
  _save(tmp, "tp_restore", rank, **{
      f"{what}/{k}": t for what, ts in (
          ("params", lay.full(state["params"])),
          ("nu", lay.full(state["opt"]["nu"], opt=True)))
      for k, t in zip(run["names"], ts)},
        local=sum(int(t.numel()) for t in state["params"]))


EVAL_PLACEMENTS = {"replicated": {}, "tensor_parallel": dict(_TP)}


def eval_config(base: dict, placement: str) -> dict:
  """`force_eval` on the tp_repl run's step-3 checkpoint on data 2 x tensor
  2 under `placement`: `val` and `mae_val` over 16 validation examples and
  a `diffusion_sampling` evaluator of 8 samples at 4 DDIM steps."""
  from small_vision_tpu_torch.configs import ae_i1k
  config = reference_config(base, "tp_repl")
  evals = ae_i1k.get_config("size=16,data=synthetic")["evals"]
  config["evals"] = {
      name: dict(evals[name], data=dict(evals[name]["data"],
                                        num_examples=16))
      for name in ("val", "mae_val")}
  config["evals"]["sample"] = dict(type="diffusion_sampling",
                                   pred="uncond_eps", total_samples=8,
                                   log_steps=25_000)
  config["num_samples_per_call"] = 4
  config["diff_schedule"] = dict(config.get("diff_schedule", {}),
                                 sampling_timesteps=4)
  config.update(EVAL_PLACEMENTS[placement], mesh_tensor=2, force_eval=True)
  return config


def eval_scenario(rank, tmp, base):
  """The evaluators through `train_and_evaluate(force_eval)` under each of
  EVAL_PLACEMENTS, on copies of the tp_repl run's checkpoints (process 0
  writes each workdir's metrics and samples)."""
  import shutil

  import torch.distributed as dist
  if rank == 0:
    for placement in EVAL_PLACEMENTS:
      shutil.copytree(os.path.join(tmp, "work_tp_repl", "checkpoints"),
                      os.path.join(tmp, f"eval_{placement}", "checkpoints"))
  dist.barrier()
  for placement in EVAL_PLACEMENTS:
    config = eval_config(base, placement)
    train_ae.train_and_evaluate(config, os.path.join(tmp, f"eval_{placement}"),
                                device="cpu", log=lambda s: None)


LATENT_PLACEMENTS = {
    "replicated": {},
    "tensor_parallel": dict(param_sharding="tensor_parallel",
                            vae_param_sharding="tensor_parallel")}


def latent_scenario(rank, tmp):
  """A latent step (the seeded VAE of channels 32 x 4, as
  tests/test_torch_latent.py's, encoding inside the step) on data 2 x
  tensor 2, every process on the same images and draws: the model
  `tensor_parallel` with `vae_param_sharding="tensor_parallel"` (which
  places the VAE replicated: no rule matches its names) against both
  replicated; the loss, the gathered gradients and the VAE a process
  holds."""
  import functools

  import torch

  from small_vision_tpu_torch.configs import ae_i1k
  from small_vision_tpu_torch.models import vae as vae_lib
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
    for name, placement in LATENT_PLACEMENTS.items():
      config = ae_i1k.get_config("runlocal,data=synthetic,total_steps=2")
      config.update(latent_diffusion=True, size=32, diffusion_space=(4, 4, 4),
                    mesh_tensor=2, **placement)
      config["model"].update(img_size=4, patch_size=(1, 1), channels=4,
                             dtype_mm="float32", attn_impl="xla")
      config["input"].update(batch_size=4, num_workers=1,
                             pp='keep("image", "label")')
      config["input"]["data"].update(img_size=32, num_examples=16)
      mesh = train_ae.build_mesh(config)
      run = train_ae.setup_training(config, "cpu", lambda s: None, mesh)
      lay = run["layout"]
      with ctx.activate_mesh(mesh):
        lay.gather(run["train_state"]["params"])
        loss, grads = run["update_fn"].loss_and_grads(
            run["train_state"], {"image": images}, draws)
        lay.release()
      out[f"loss_{name}"] = loss
      out[f"local_{name}"] = sum(
          int(t.numel()) for t in run["train_state"]["params"])
      out[f"vae_{name}"] = sum(
          int(t.numel()) for t in run["train_state"]["vae_params"].values())
      for k, g in zip(run["names"], lay.full(grads)):
        out[f"g_{name}/{k}"] = g
  finally:
    vae_lib.load_vae = load_vae
  _save(tmp, "tp_latent", rank, **out)


def run(rank, n, device, tmp):
  del n, device
  with open(os.path.join(tmp, "train_config.json")) as f:
    base = json.load(f)
  plan = np.load(os.path.join(tmp, "train_plan.npz"))
  train_scenario(rank, tmp, base, plan)
  restore_scenario(rank, tmp, base)
  eval_scenario(rank, tmp, base)
  latent_scenario(rank, tmp)
