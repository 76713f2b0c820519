"""Port parity: tensor-parallel training in 4 processes, against one process
and the JAX package.

One module-scoped fixture takes tests/test_torch_parallel_multiproc.py's
plan (its config under attn_impl "xla", the JAX step's batches and draws,
`model_init` weights), runs the one-process port on it (and with dropout
0.1, and under `scan=True`), spawns 4 gloo processes on the CPU once
(`tools.dryrun_multichip.spawn` over a `FileStore` in `tmp_path`; each is
killed at 120 s, which fails the fixture) running
`tests/test_torch_tensor_parallel_worker.py:run`, and runs JAX's step on a
mesh of 4 virtual devices with each case's strategy. The tests hold, for
each case of `TP_CASES` (3 steps through `train_and_evaluate`):

  - data 2 x tensor 2: `tensor_parallel` with the optimizer state
    replicated (JAX's default) and `tensor_parallel` (with an EMA, held
    to one process's); with dropout 0.1
    (the masks drawn by the port's own generator, not injected); under
    `scan=True`;
  - fsdp 2 x tensor 2: `tp_fsdp` (`min_size_to_shard=0`) with the
    optimizer state `tp_fsdp` and replicated, and `tensor_parallel`
    parameters with a `fully_sharded` optimizer state (over `fsdp`);

the losses within rtol 2e-4 and atol 1e-5 of the one-process port run
(tests/test_fsdp_equivalence.py's bound) and equal on the processes that
differ only on `tensor`; the gathered nu within rtol 1e-4 of one
process's; the parameters within tests/test_torch_train_step.py's bounds
of JAX's step on data 2 x tensor 2 with the same strategies
(`tensor_parallel`, the optimizer state replicated), and of JAX's
one-device step for the other placements (the dropout and scan cases: of
the one-process port run's; JAX does not draw the port's masks, and its
stacked names are the scan run's); each process's
element counts and state bytes as JAX's `infer_sharding` places them;
the tensor_parallel run's checkpoint restored in one process, and the
one-process run's restored under tensor_parallel, bit-equal; a latent
step (the VAE encode inside) under `tensor_parallel` with
`vae_param_sharding="tensor_parallel"` against both replicated.
(`tools/dryrun_multichip.py`'s fsdp 2 x tensor 2 step at n = 4 runs in
tests/test_torch_parallel_multiproc.py's processes.)
"""

import concurrent.futures
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_parallel_worker as parallel_worker
from test_torch_parallel_multiproc import B, STEPS, _jax_training, _train_config
from test_torch_tensor_parallel_worker import (EVAL_PLACEMENTS, REFERENCE,
                                               TP_CASES, case_config,
                                               reference_config)
from test_torch_train_step import OPT, SIZE, T, step_inputs

from small_vision_tpu import optim as joptim
from small_vision_tpu import parallel as jparallel
from small_vision_tpu.models import ae as jae
from small_vision_tpu.ops import diffusion as jgd
from small_vision_tpu.parallel.ctx import activate_mesh
from small_vision_tpu.train import train_ae as jtrain
from small_vision_tpu_torch import convert
from small_vision_tpu_torch.parallel import mesh as mesh_lib
from small_vision_tpu_torch.parallel import sharding
from small_vision_tpu_torch.tools import dryrun_multichip
from small_vision_tpu_torch.train import train_ae
from small_vision_tpu_torch.utils import checkpoint as ckpt_lib
from small_vision_tpu_torch.utils.chrono import Chrono
from small_vision_tpu_torch.utils.trees import tree_flatten_with_names

N = 4
TESTS = os.path.dirname(os.path.abspath(__file__))
# The case held to JAX's step on the same 4-device mesh with the same
# strategies (JAX's default placement of tensor parallelism; such a run
# compiles for 17-25 s, and the file keeps within 90 s); the others to
# JAX's one-device step, which GSPMD's partitioned steps equal up to the
# order of their sums.
JAX_CASES = ("tp_repl",)


def _jax_sharded_training(config, params):
  """3 steps of JAX's step on a mesh of 4 virtual devices with the
  config's mesh and strategies (the injected draws make its masks those of
  the one-device run); its parameters, flat."""
  kw = dict(config["model"])
  model = jae.Model(**kw)
  tx, _ = joptim.adamw_trainer_tx(
      peak_lr=OPT["peak_lr"], batch_size=B, total_steps=OPT["total_steps"],
      warmup_steps=OPT["warmup_steps"], wd=OPT["wd"], betas=OPT["betas"],
      clip_norm=OPT["clip_norm"])
  cfg = dict(no_noise_prob=config["no_noise_prob"],
             mask_ratio=config["mask_ratio"],
             mask_ratio_no_noise=config["mask_ratio_no_noise"],
             use_labels=False, fused_branches=False, l2_metrics=True,
             _inject_draws=True, diffusion_space=(SIZE, SIZE, 3))
  mesh = jparallel.make_mesh(jax.devices()[:N],
                             fsdp=int(config.get("mesh_fsdp", 1)),
                             tensor=int(config["mesh_tensor"]))
  strategy_kw = lambda s: {"min_size_to_shard": 0} if s == "tp_fsdp" else {}
  p_s = config["param_sharding"]
  o_s = config.get("optim_sharding", "replicated")
  jparams = jax.tree.map(jnp.asarray, params)
  state = {"params": jparams, "opt": tx.init(jparams),
           "rng": jax.random.PRNGKey(7),
           "gd": jgd.GaussianDiffusion.create("cosine", T)}
  repl = jparallel.replicated_sharding(mesh)
  shardings = {
      "params": jparallel.infer_sharding(jparams, mesh, p_s, **strategy_kw(
          p_s)),
      "opt": jparallel.infer_sharding(state["opt"], mesh, o_s,
                                      **strategy_kw(o_s)),
      "rng": repl, "gd": jax.tree.map(lambda _: repl, state["gd"])}
  with activate_mesh(mesh):
    state = jax.device_put(state, shardings)
    update = jtrain.make_update_fn(model, tx, cfg, None, mesh, shardings)
    n_no_noise = int(B * config["no_noise_prob"])
    for step in range(STEPS):
      jbatch, _, _ = step_inputs(step, B - n_no_noise, False)
      state, _ = update.with_l2(state, jbatch)
  return dict(tree_flatten_with_names(jax.device_get(state["params"])))


def _one_process(config, plan, workdir):
  """The one-process port run through `train_and_evaluate` on the plan's
  batches and draws: (losses, then {name: array} of its parameters, nu
  and EMA)."""
  losses, state = parallel_worker.train_steps(dict(config), workdir, plan)
  names = [n for n, _ in train_ae.named_params(train_ae.build_model(
      config, device="meta"))]
  arrays = lambda ts: {n: t.detach().numpy() for n, t in zip(names, ts)}
  return (losses, arrays(state["params"]), arrays(state["opt"]["nu"]),
          arrays(state.get("ema_params", [])))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
  tmp = str(tmp_path_factory.mktemp("tp_multiproc"))
  config, init = _train_config(tmp)
  ckpt_lib.save_params_npz(os.path.join(tmp, "init_scan.npz"),
                           convert.stack_blocks(init))
  with pytest.MonkeyPatch.context() as mp:
    train_plan, jax_one = _jax_training(config, init, mp)
  np.savez(os.path.join(tmp, "train_plan.npz"), **train_plan)
  with open(os.path.join(tmp, "train_config.json"), "w") as f:
    json.dump(config, f)
  with open(os.path.join(tmp, "train_config.json")) as f:
    config = json.load(f)  # what the processes read
  plan = np.load(os.path.join(tmp, "train_plan.npz"))
  one = {"base": _one_process(config, plan, os.path.join(tmp,
                                                          "work_single"))}
  for case in REFERENCE:
    one[case] = _one_process(reference_config(config, case), plan,
                             os.path.join(tmp, f"single_{case}"))
  def processes():
    t0 = time.monotonic()
    logs = dryrun_multichip.spawn(
        "test_torch_tensor_parallel_worker:run", N, args=(tmp,),
        timeout=120, threads=1, env={"PYTHONPATH": TESTS})
    return logs, time.monotonic() - t0
  # The processes run while JAX compiles its sharded steps here.
  with concurrent.futures.ThreadPoolExecutor(1) as pool:
    spawned = pool.submit(processes)
    jax_runs = {case: _jax_sharded_training(case_config(config, case), init)
                if case in JAX_CASES else jax_one
                for case in TP_CASES if "model" not in TP_CASES[case][1]}
    logs, seconds = spawned.result()
  out = {}
  for name in os.listdir(os.path.join(tmp, "out")):
    key, rank = name[:-len(".npz")].rsplit("_rank", 1)
    out.setdefault(key, [None] * N)[int(rank)] = dict(
        np.load(os.path.join(tmp, "out", name)))
  return {"tmp": tmp, "out": out, "logs": logs, "one": one,
          "config": config, "jax": jax_runs, "init": init,
          "seconds": seconds}


def _placed_count(params, mesh, strategy, config):
  """Elements of `params` ({name: array}) one process holds under JAX's
  `infer_sharding(strategy)` on the JAX mesh of `mesh`'s shape (with the
  config's `min_size_to_shard`)."""
  jmesh = jparallel.make_mesh(jax.devices()[:N], **{
      a: s for a, s in mesh.shape.items() if a != "data"})
  kw = ({"min_size_to_shard": config["min_size_to_shard"]}
        if strategy in ("fully_sharded", "tp_fsdp")
        and "min_size_to_shard" in config else {})
  shards = jparallel.infer_sharding(
      {n: jax.ShapeDtypeStruct(v.shape, jnp.float32)
       for n, v in params.items()}, jmesh, strategy, **kw)
  return sum(int(np.prod(shards[n].shard_shape(v.shape)))
             for n, v in params.items())


@pytest.mark.parametrize("case", list(TP_CASES))
def test_tensor_parallel_training_matches_one_process_and_jax(results, case):
  got = results["out"][f"tp_{case}"]
  one_losses, one_params, one_nu, one_ema = results["one"][
      case if case in REFERENCE else "base"]
  config = case_config(results["config"], case)
  mesh = mesh_lib.make_mesh(N, fsdp=int(config.get("mesh_fsdp", 1)),
                            tensor=int(config["mesh_tensor"]))
  assert json.loads(str(got[0]["mesh"])) == mesh.shape
  for rank, g in enumerate(got):
    assert len(g["losses"]) == STEPS
    np.testing.assert_allclose(g["losses"], one_losses, rtol=2e-4,
                               atol=1e-5)
    # The processes that differ only on `tensor` hold the same rows.
    partner = got[rank ^ 1]
    np.testing.assert_array_equal(g["losses"], partner["losses"])
    for name, want in one_nu.items():
      np.testing.assert_allclose(g[f"nu/{name}"], want, rtol=1e-4,
                                 atol=1e-12, err_msg=name)
  # Each process holds what JAX's placement gives it, in f32 parameters
  # (and an f32 EMA, placed as they are), bf16 mu and f32 nu.
  local = _placed_count(one_params, mesh, config["param_sharding"], config)
  opt_local = _placed_count(one_params, mesh,
                            config.get("optim_sharding", "replicated"),
                            config)
  assert [int(g["local"]) for g in got] == [local] * N
  assert [int(g["opt_local"]) for g in got] == [opt_local] * N
  ema = 4 * local if one_ema else 0
  assert [int(g["state_bytes"]) for g in got] == [
      4 * local + ema + (2 + 4) * opt_local] * N
  full = sum(v.size for v in one_params.values())
  assert local < full  # the projections are split
  # The parameters: the one-process port's to f32 round-off; JAX's sharded
  # step's within test_torch_train_step.py's bounds (the dropout and scan
  # cases: the one-process port's).
  lr = OPT["peak_lr"] * B / 256.0
  want_tree = results["jax"].get(case)
  within, total = 0, 0
  for name, p1 in one_params.items():
    p = got[0][f"p/{name}"]
    np.testing.assert_array_equal(p, got[1][f"p/{name}"])
    np.testing.assert_allclose(p, p1, rtol=1e-4, atol=1e-2 * lr,
                               err_msg=name)
    want = p1 if want_tree is None else want_tree[name]
    diff = np.abs(p - want)
    assert np.max(diff) <= 5e-2 * lr, (name, np.max(diff) / lr)
    within += int(np.sum(diff <= 1e-2 * lr))
    total += diff.size
  assert within >= 0.99 * total, (within, total)
  for name, e1 in one_ema.items():  # the EMA, gathered, as one process's
    np.testing.assert_allclose(got[0][f"ema/{name}"], e1, rtol=1e-4,
                               atol=1e-2 * lr, err_msg=name)


def test_tensor_parallel_checkpoint_restores_in_one_process(results):
  """The tp_repl run's step-3 checkpoint (gathered, written by process 0)
  in one process: the parameters the 4 processes held, bit for bit."""
  config = dict(results["config"])
  mngr = ckpt_lib.make_manager(os.path.join(results["tmp"], "work_tp_repl"))
  assert mngr.latest_step() == STEPS
  run = train_ae.setup_training(config, "cpu", lambda s: None)
  train_ae.load_checkpoint_state(run["train_state"], run["names"],
                                 ckpt_lib.restore(mngr), Chrono())
  got = results["out"]["tp_tp_repl"][0]
  for name, p in zip(run["names"], run["train_state"]["params"]):
    np.testing.assert_array_equal(p.detach().numpy(), got[f"p/{name}"])
  from small_vision_tpu_torch.tools import export_sampler
  params, step, _ = export_sampler.load_params(
      config, os.path.join(results["tmp"], "work_tp_repl"))
  assert step == STEPS
  for name, t in tree_flatten_with_names(params):
    np.testing.assert_array_equal(t.numpy(), got[f"p/{name}"])


def test_one_process_checkpoint_restores_under_tensor_parallel(results):
  """The one-process run's step-3 checkpoint under tensor_parallel: each
  process's parts, gathered, are the checkpoint's tensors; a process holds
  half of the projections."""
  mngr = ckpt_lib.make_manager(os.path.join(results["tmp"], "work_single"))
  restored = ckpt_lib.restore(mngr)
  params = dict(tree_flatten_with_names(restored["params"]))
  opt = dict(tree_flatten_with_names(restored["opt"]))
  got = results["out"]["tp_restore"]
  for g in got:
    for name, t in params.items():
      np.testing.assert_array_equal(g[f"params/{name}"], t.numpy())
      np.testing.assert_array_equal(g[f"nu/{name}"], opt[f"nu/{name}"].numpy())
  full = sum(t.numel() for t in params.values())
  tp = sum(t.numel() for n, t in params.items()
           if sharding.spec_axis(sharding.tensor_parallel(
               {n: t}, mesh_lib.make_mesh(N, tensor=2))[n]))
  assert [int(g["local"]) for g in got] == [full - tp // 2] * N


def test_evaluators_under_tensor_parallel(results):
  """`val`, `mae_val` and a sampling evaluator (8 samples, 4 DDIM steps)
  on the tp_repl run's step-3 checkpoint, under `tensor_parallel` and
  under `replicated` on the same data 2 x tensor 2 mesh (the same rows and
  draws a batch shard): the metrics within rtol 1e-5, the samples (uint8)
  within one level."""
  got = {}
  for placement in EVAL_PLACEMENTS:
    work = os.path.join(results["tmp"], f"eval_{placement}")
    with open(os.path.join(work, "sv_tpu_metrics.txt")) as f:
      rows = [json.loads(line) for line in f]
    metrics = {k: v for row in rows for k, v in row.items()
               if k.startswith(("val/", "mae_val/"))}
    samples = np.load(os.path.join(work, "sample_samples",
                                   f"samples_{STEPS}.npz"))["samples"]
    got[placement] = metrics, samples
  (tp, tp_samples), (repl, repl_samples) = (got["tensor_parallel"],
                                            got["replicated"])
  assert sorted(tp) == sorted(repl) and any(k.startswith("val/") for k in tp)
  for k, v in repl.items():
    np.testing.assert_allclose(tp[k], v, rtol=1e-5, err_msg=k)
  assert tp_samples.shape == repl_samples.shape and tp_samples.shape[0] == 8
  diff = np.abs(tp_samples.astype(np.int64) - repl_samples.astype(np.int64))
  assert diff.max() <= 1, diff.max()


def test_latent_step_under_tensor_parallel(results):
  """A latent step with the VAE encode inside, on data 2 x tensor 2: the
  model `tensor_parallel` and `vae_param_sharding="tensor_parallel"`
  against both replicated on the same mesh and rows: the loss and the
  gradients to f32 round-off (1e-5 of each leaf's largest, floored at
  1e-2 of the largest of all: the key biases' gradient is round-off),
  the projections split, the VAE whole on every process."""
  for g in results["out"]["tp_latent"]:
    np.testing.assert_allclose(float(g["loss_tensor_parallel"]),
                               float(g["loss_replicated"]), rtol=1e-6)
    want = {k[len("g_replicated/"):]: v for k, v in g.items()
            if k.startswith("g_replicated/")}
    top = max(float(np.abs(v).max()) for v in want.values())
    for name, w in want.items():
      err = np.abs(g[f"g_tensor_parallel/{name}"] - w).max()
      assert err <= 1e-5 * max(np.abs(w).max(), 1e-2 * top), (name, err)
    assert int(g["local_tensor_parallel"]) < int(g["local_replicated"])
    assert int(g["vae_tensor_parallel"]) == int(g["vae_replicated"])


def test_tensor_parallel_processes_ended_within_their_limit(results):
  assert results["seconds"] < 120, results["seconds"]
