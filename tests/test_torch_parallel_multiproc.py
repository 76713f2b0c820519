"""Port parity: the parallel layer in 4 processes, against one process and
the JAX package.

One module-scoped fixture writes a plan (weights, batches, draws) to
`tmp_path`, spawns 4 gloo processes on the CPU once
(`tools.dryrun_multichip.spawn`, over a `FileStore` there, so that xdist
workers never race for a port; each process is killed at 120 s, which
fails the fixture) running `tests/test_torch_parallel_worker.py:run`, and
the tests read what the processes wrote:

  - `process_allgather`, `fetch_global`, `broadcast_one_to_all`,
    `gather_metrics`, the host all-reduce, and the differentiable gather
    and scatter with their backwards: exact;
  - the `mean` evaluator through `make_for_inference` on a ragged split
    (41 examples: 11/10/10/10) and one with an empty shard (3: 1/1/1/0):
    every process runs the same steps, and the means equal one process's
    (1e-6, the sums' order);
  - the explicit step, dp (data 4) and zero3 (data 2 x fsdp 2, and fsdp 4
    with the clip on the norm summed over fsdp), two steps of AdamW,
    against JAX `make_explicit_update_fn` on the same mesh of 4 virtual
    devices: losses within rtol 1e-5 and atol 1e-6, parameters within
    rtol 2e-4 and atol 2e-5 (tests/test_explicit_step.py's bounds);
  - `pipeline_apply` and `pipeline_apply_stacked` on data 2 x pipe 2
    against the sequential stack, and the model's `pipe_stages=2` against
    `scan=True`: forward within rtol and atol 3e-5, gradients within 5e-4
    and 5e-5 (tests/test_pipeline_parallel.py's bounds);
  - 3 training steps through `train_and_evaluate` (warm-started by
    `model_init`, stopped at step 4), `replicated`, `fully_sharded` (fsdp
    4), data 2 x fsdp 2, ZeRO-1 (replicated parameters, `optim_sharding`
    `fully_sharded` over fsdp 4) and sharded parameters with the
    optimizer state's default placement, replicated (JAX's default), each
    process on its rows of the JAX step's
    batch with the JAX step's draws (tests/test_torch_train_step.py's
    harness, its config under attn_impl "xla"): losses within rtol 2e-4
    and atol 1e-5 of the one-process port run
    (tests/test_fsdp_equivalence.py's bound), and the parameters held to
    the JAX step's within tests/test_torch_train_step.py's bounds; each
    process's element counts of parameters and optimizer state, and its
    state bytes (f32 parameters, bf16 mu, f32 nu), follow the two
    placements, and the gathered nu equals one process's (rtol 1e-4);
  - a `fully_sharded` checkpoint restored in one process, and a
    one-process checkpoint restored in 4: bit-equal; the fully_sharded
    run's checkpoint read by `tools/export_sampler.py::load_params` (no
    EMA: its `params`) as the 4 processes held them;
  - `tools/dryrun_multichip.py`'s steps at n = 4 (fsdp, pipe, and the
    data x fsdp x tensor `tp_fsdp` one);
  - `vae_param_sharding`: a latent step (a seeded VAE of channels 32 x
    4, 32 px images) with
    the VAE replicated and fully_sharded over fsdp 4, the same loss bit
    for bit, a quarter of the VAE a process, a checkpoint of the whole.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_parallel_worker import (EXPLICIT_CASES, EXPLICIT_TINY,
                                        PIPE_MODEL, TRAIN_CASES,
                                        explicit_opt, sequential, tanh_block)
from test_torch_train_step import (OPT, install_capture, jax_side,
                                   port_draws, small_config, step_inputs)

from small_vision_tpu import optim as joptim
from small_vision_tpu import parallel as jparallel
from small_vision_tpu.models import ae as jae
from small_vision_tpu.ops import diffusion as jgd
from small_vision_tpu.parallel import explicit_step as jexplicit
from small_vision_tpu_torch import convert
from small_vision_tpu_torch.evaluators import mean as mean_eval
from small_vision_tpu_torch.models import ae as tae
from small_vision_tpu_torch.parallel import mesh as mesh_lib
from small_vision_tpu_torch.parallel import sharding
from small_vision_tpu_torch.tools import dryrun_multichip
from small_vision_tpu_torch.train import train_ae
from small_vision_tpu_torch.utils import checkpoint as ckpt_lib
from small_vision_tpu_torch.utils.chrono import Chrono
from small_vision_tpu_torch.utils.trees import tree_flatten_with_names

_jae_model = jae.Model
N = 4
TESTS = os.path.dirname(os.path.abspath(__file__))
B = 8  # the training batch (test_torch_train_step's)
STEPS = 3


def _explicit_plan(rng):
  model = jae._ViTAE(**{k: v for k, v in EXPLICIT_TINY.items()
                        if k != "attn_impl"})
  params = model.init({"params": jax.random.PRNGKey(0)},
                      jnp.zeros((2, 16, 16, 3)),
                      t=jnp.zeros((2,), jnp.int32))["params"]
  port = tae.Model(**EXPLICIT_TINY)
  state = convert.params_from_jax(jax.device_get(params), port)
  plan = {f"p/{k}": v.numpy() for k, v in state.items()}
  for step in range(2):
    plan[f"image{step}"] = rng.normal(size=(16, 16, 16, 3)).astype(np.float32)
    plan[f"t{step}"] = rng.integers(0, 50, 16).astype(np.int32)
    plan[f"noise{step}"] = rng.normal(size=(16, 16, 16, 3)).astype(np.float32)
  return params, plan


def _pipe_plan(rng):
  plan = {"w": rng.normal(size=(8, 16, 16)).astype(np.float32) * 0.3,
          "b": np.zeros((8, 16), np.float32),
          "v": rng.normal(size=(8, 16, 16)).astype(np.float32) * 0.3,
          "x": rng.normal(size=(16, 16)).astype(np.float32),
          "tgt": rng.normal(size=(16, 16)).astype(np.float32),
          "img": rng.normal(size=(8, 16, 16, 3)).astype(np.float32),
          "t": (np.arange(8) % 5 + 1).astype(np.int64)}
  model = tae.Model(**PIPE_MODEL)
  config = {"model": PIPE_MODEL, "model_name": "ae"}
  state = convert.params_from_jax(convert.init_params(config, 4), model)
  plan.update({f"m/{k}": v.numpy() for k, v in state.items()})
  return plan


def _train_config(tmp):
  """test_torch_train_step's config and optimizer schedule (10 steps, of
  which the runs take 3), from its `init_params` weights (`model_init`)."""
  config = small_config(attn_impl="xla")
  config.update(total_steps=10, log_training_steps=1, ckpt_steps=STEPS)
  config["input"]["num_workers"] = 1
  config["input"]["data"]["num_examples"] = 64
  config.pop("total_epochs", None)
  config.pop("warmup_epochs", None)
  params = convert.init_params(config, seed=3)
  config["model_init"] = os.path.join(tmp, "init.npz")
  ckpt_lib.save_params_npz(config["model_init"], params)
  return config, params


def _jax_training(config, params, monkeypatch):
  """3 steps of the JAX step as test_torch_train_step runs it; returns
  (the plan: its batches and the draws it made, its parameters)."""
  cap = install_capture(monkeypatch)
  # jax_side runs the JAX model under attn_impl + "_interpret"; "xla" has
  # no Pallas kernel to interpret.
  monkeypatch.setattr(jae, "Model", lambda **kw: _jae_model(**dict(
      kw, attn_impl=kw["attn_impl"].replace("_interpret", ""))))
  jstate, jupdate = jax_side(config, params)
  n_no_noise = int(B * config["no_noise_prob"])
  plan = {}
  for step in range(STEPS):
    jbatch, tbatch, base = step_inputs(step, B - n_no_noise, False)
    cap.clear()
    jstate, _ = jupdate.with_l2(jstate, jbatch)
    jax.effects_barrier()
    draws = port_draws(config, cap, base, n_no_noise)
    plan[f"image{step}"] = tbatch["image"]
    for k in ("t", "noise", "mae_noise", "dit_noise"):
      plan[f"{k}{step}"] = np.asarray(draws[k])
  return plan, dict(tree_flatten_with_names(jax.device_get(
      jstate["params"])))


def _one_process_training(config, plan, workdir):
  """The one-process port run through `train_and_evaluate`, on the plan's
  batches and draws (the workers' patched step, with one shard)."""
  import test_torch_parallel_worker as worker
  losses, state = worker.train_steps(dict(config), workdir, plan)
  names = [n for n, _ in train_ae.named_params(train_ae.build_model(
      config, device="meta"))]
  return losses, {n: p.detach().numpy()
                  for n, p in zip(names, state["params"])}, {
                      n: t.numpy() for n, t in zip(names, state["opt"]["nu"])}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
  tmp = str(tmp_path_factory.mktemp("multiproc"))
  rng = np.random.default_rng(0)
  jparams, plan = _explicit_plan(rng)
  np.savez(os.path.join(tmp, "explicit_plan.npz"), **plan)
  np.savez(os.path.join(tmp, "pipe_plan.npz"), **_pipe_plan(rng))
  config, init = _train_config(tmp)
  with pytest.MonkeyPatch.context() as mp:
    train_plan, jax_train = _jax_training(config, init, mp)
  np.savez(os.path.join(tmp, "train_plan.npz"), **train_plan)
  with open(os.path.join(tmp, "train_config.json"), "w") as f:
    json.dump(config, f)
  with open(os.path.join(tmp, "train_config.json")) as f:
    config = json.load(f)  # what the processes read
  one = _one_process_training(config, np.load(os.path.join(
      tmp, "train_plan.npz")), os.path.join(tmp, "work_single"))
  t0 = time.monotonic()
  logs = dryrun_multichip.spawn(
      "test_torch_parallel_worker:run", N, args=(tmp,), timeout=120,
      threads=1, env={"PYTHONPATH": TESTS})
  out = {}
  for name in os.listdir(os.path.join(tmp, "out")):
    key, rank = name[:-len(".npz")].rsplit("_rank", 1)
    out.setdefault(key, [None] * N)[int(rank)] = dict(
        np.load(os.path.join(tmp, "out", name)))
  return {"tmp": tmp, "out": out, "logs": logs, "jparams": jparams,
          "jax_train": jax_train, "one": one, "config": config,
          "seconds": time.monotonic() - t0}


def test_collectives_across_processes(results):
  mine = [np.full((2, 3), r, np.float32) for r in range(N)]
  w = np.arange(2.0 * N * 3).reshape(2 * N, 3)
  for r, got in enumerate(results["out"]["collectives"]):
    # d/dx of sum(gather(x) * w): every process's w rows of x, summed.
    np.testing.assert_array_equal(got["g_gather"], N * w[2 * r:2 * r + 2])
    np.testing.assert_array_equal(got["part"], w[2 * r:2 * r + 2])
    # d/dy of sum(scatter(y) * (rank + 1)), gathered: rank q's block q + 1.
    np.testing.assert_array_equal(
        got["g_scatter"], np.repeat(np.arange(1.0, N + 1), 2)[:, None]
        * np.ones((1, 3)))
    np.testing.assert_array_equal(got["tiled"], np.concatenate(mine))
    np.testing.assert_array_equal(got["stacked"], np.stack(mine))
    np.testing.assert_array_equal(got["fetched"], np.concatenate(mine) + 10)
    np.testing.assert_array_equal(got["bcast"], np.arange(3.0))
    np.testing.assert_array_equal(
        got["metric"], np.array([[q, q + 0.5] for q in range(N)]).ravel())
    np.testing.assert_array_equal(got["summed"], [sum(range(N)), N])


@pytest.mark.parametrize("total,shards", [(41, [11, 10, 10, 10]),
                                          (3, [1, 1, 1, 0])])
def test_mean_evaluator_equals_one_process(results, total, shards):
  got = results["out"][f"eval{total}"]
  assert [int(g["shard"]) for g in got] == shards
  assert len({int(g["steps"]) for g in got}) == 1  # no process waits
  ev = mean_eval.Evaluator(
      lambda _, batch: {"m": batch["image"].float().mean((1, 2, 3)),
                        "lab": batch["label"].float()},
      device="cpu", batch_size=8, pp_fn="value_range(-1, 1)",
      data=dict(name="synthetic", split="validation", img_size=8,
                num_examples=total, pool=64))
  want = dict(ev.run(None))
  assert want["lab"] == pytest.approx(np.mean(np.arange(total) % 1000))
  for g in got:
    for k in want:
      np.testing.assert_allclose(float(g[k]), want[k], rtol=1e-6, atol=1e-7)


def _jax_explicit(jparams, plan, kw, strategy, clip):
  mesh = jparallel.make_mesh(jax.devices()[:N], **kw)
  model = jae._ViTAE(**{k: v for k, v in EXPLICIT_TINY.items()
                        if k != "attn_impl"})
  tx, _ = joptim.adamw_trainer_tx(
      peak_lr=1e-3 * 256 / 16, batch_size=16, total_steps=10, warmup_steps=1,
      wd=0.05, clip_norm=1e9, mu_dtype="float32")
  pstrat = "fully_sharded" if strategy == "zero3" else "replicated"
  skw = dict(min_size_to_shard=1024) if strategy == "zero3" else {}
  opt = tx.init(jparams)
  p_shard = jparallel.infer_sharding(jax.eval_shape(lambda: jparams), mesh,
                                     pstrat, **skw)
  o_shard = jparallel.infer_sharding(jax.eval_shape(lambda: opt), mesh,
                                     pstrat, **skw)
  repl = jparallel.replicated_sharding(mesh)
  state = {"params": jax.tree.map(jax.device_put, jparams, p_shard),
           "opt": jax.tree.map(jax.device_put, opt, o_shard),
           "gd": jparallel.reshard(jgd.GaussianDiffusion.create("cosine", 50),
                                   repl)}
  make = jexplicit.make_explicit_update_fn(
      model, tx, mesh, strategy=strategy, channels=3, min_size_to_shard=1024,
      grad_clip_norm=clip)
  bs = jparallel.batch_sharding(mesh)
  losses, update = [], None
  for step in range(2):
    batch = {k: jax.device_put(jnp.asarray(plan[f"{k}{step}"]), bs)
             for k in ("image", "t", "noise")}
    update = update or make(state, batch)
    state, loss = update(state, batch)
    losses.append(float(jax.device_get(loss)))
  return losses, dict(tree_flatten_with_names(jax.device_get(
      state["params"])))


@pytest.mark.parametrize("case", list(EXPLICIT_CASES))
def test_explicit_step_matches_jax(results, case):
  kw, strategy, clip = EXPLICIT_CASES[case]
  plan = dict(np.load(os.path.join(results["tmp"], "explicit_plan.npz")))
  want_losses, want = _jax_explicit(results["jparams"], plan, kw, strategy,
                                    clip)
  got = results["out"][f"explicit_{case}"]
  assert (int(got[0]["sharded"]) > 0) == (strategy == "zero3")
  for g in got:
    np.testing.assert_allclose(g["losses"], want_losses, rtol=1e-5,
                               atol=1e-6)
  moved = 0
  for name, w in want.items():
    init = plan[f"p/{name.replace('/', '.')}"]
    np.testing.assert_allclose(got[0][f"p/{name}"], w, rtol=2e-4, atol=2e-5,
                               err_msg=name)
    moved += not np.array_equal(w, init)
    for g in got[1:]:  # every process ends with the same parameters
      np.testing.assert_array_equal(g[f"p/{name}"], got[0][f"p/{name}"])
  assert moved  # the second step (lr > 0) moved the weights


@pytest.mark.parametrize("api", ["staged", "stacked"])
def test_pipeline_apply_matches_sequential(results, api):
  plan = np.load(os.path.join(results["tmp"], "pipe_plan.npz"))
  stacked = {k: torch.from_numpy(plan[k]).requires_grad_(True)
             for k in ("w", "b", "v")}
  x = torch.from_numpy(plan["x"]).requires_grad_(True)
  ref = sequential(stacked, x)
  loss = torch.mean((ref - torch.from_numpy(plan["tgt"])) ** 2)
  g_ref = torch.autograd.grad(loss, [x] + [stacked[k] for k in "wbv"])
  got = results["out"][f"pipe_{api}"]
  for g in got:
    rows = slice(int(g["rows"][0]), int(g["rows"][0]) + 8)
    np.testing.assert_allclose(g["out"], ref[rows].detach().numpy(),
                               rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(g["gx"], g_ref[0][rows].numpy(), rtol=5e-4,
                               atol=5e-5)
    s = int(g["stage"])
    for k, gr in zip("wbv", g_ref[1:]):
      want = gr[4 * s:4 * (s + 1)].numpy()
      np.testing.assert_allclose(g[f"g{k}"].reshape(want.shape), want,
                                 rtol=5e-4, atol=5e-5, err_msg=k)


def test_model_pipeline_equals_scan(results):
  """pipe_stages=2 (2 microbatches) on data 2 x pipe 2 against the
  scan=True model on the whole batch: K1-K4's plain versions in every
  stage."""
  plan = np.load(os.path.join(results["tmp"], "pipe_plan.npz"))
  model = tae.Model(**PIPE_MODEL).train()
  model.load_state_dict({k: torch.from_numpy(plan[f"m/{k}"])
                         for k in model.state_dict()})
  pred, _ = model(torch.from_numpy(plan["img"]),
                  t=torch.from_numpy(plan["t"]))
  named = sorted(model.named_parameters())
  grads = torch.autograd.grad(torch.mean(pred ** 2), [p for _, p in named],
                              allow_unused=True, materialize_grads=True)
  got = results["out"]["pipe_model"]
  for g in got:
    rows = slice(int(g["rows"][0]), int(g["rows"][0]) + 4)
    np.testing.assert_allclose(g["pred"], pred[rows].detach().numpy(),
                               rtol=3e-5, atol=3e-5)
    for (name, _), want in zip(named, grads):
      np.testing.assert_allclose(g[f"g/{name}"], want.numpy(), rtol=5e-4,
                                 atol=5e-5, err_msg=name)


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_training_matches_one_process_and_jax(results, case):
  got = results["out"][f"train_{case}"]
  one_losses, one_params, one_nu = results["one"]
  for g in got:
    assert len(g["losses"]) == STEPS
    np.testing.assert_allclose(g["losses"], one_losses, rtol=2e-4,
                               atol=1e-5)
    for name, want in one_nu.items():
      np.testing.assert_allclose(g[f"nu/{name}"], want, rtol=1e-4,
                                 atol=1e-12, err_msg=name)
  # Each process holds its shards: the element counts the two placements
  # give (JAX's defaults: both replicated), and the bytes of them.
  config = dict(results["config"], **TRAIN_CASES[case])
  mesh = mesh_lib.make_mesh(N, fsdp=int(config.get("mesh_fsdp", 1)))

  def local_count(strategy):
    specs = sharding.infer_sharding(
        {n: v for n, v in one_params.items()}, mesh, strategy,
        **({"min_size_to_shard": 0} if strategy == "fully_sharded" else {}))
    return sum(int(np.prod(sharding.shard_shape(v.shape, specs[n], mesh)))
               for n, v in one_params.items())
  local = local_count(config.get("param_sharding", "replicated"))
  opt_local = local_count(config.get("optim_sharding", "replicated"))
  assert [int(g["local"]) for g in got] == [local] * N
  assert [int(g["opt_local"]) for g in got] == [opt_local] * N
  ema = 4 * local if config.get("ema_decay") else 0
  assert [int(g["state_bytes"]) for g in got] == [
      4 * local + ema + (2 + 4) * opt_local] * N
  full = sum(v.size for v in one_params.values())
  for count, strategy in ((local, config.get("param_sharding")),
                          (opt_local, config.get("optim_sharding"))):
    assert count < full / 1.9 if strategy == "fully_sharded" else \
        count == full
  lr = OPT["peak_lr"] * B / 256.0
  within, total = 0, 0
  for name, want in results["jax_train"].items():
    p = got[0][f"p/{name}"]
    np.testing.assert_allclose(p, one_params[name], rtol=1e-4, atol=1e-2 * lr,
                               err_msg=name)
    diff = np.abs(p - want)
    assert np.max(diff) <= 5e-2 * lr, (name, np.max(diff) / lr)
    within += int(np.sum(diff <= 1e-2 * lr))
    total += diff.size
  assert within >= 0.99 * total, (within, total)


def test_fully_sharded_checkpoint_restores_in_one_process(results):
  """The fsdp=4 run's step-3 checkpoint (gathered, written by process 0)
  in one process: the parameters and moments the 4 processes held."""
  config = dict(results["config"])
  mngr = ckpt_lib.make_manager(os.path.join(results["tmp"],
                                            "work_fully_sharded"))
  assert mngr.latest_step() == STEPS
  run = train_ae.setup_training(config, "cpu", lambda s: None)
  train_ae.load_checkpoint_state(run["train_state"], run["names"],
                                 ckpt_lib.restore(mngr), Chrono())
  got = results["out"]["train_fully_sharded"][0]
  for name, p in zip(run["names"], run["train_state"]["params"]):
    np.testing.assert_array_equal(p.detach().numpy(), got[f"p/{name}"])
  assert run["train_state"]["opt"]["count"] == STEPS


def test_vae_param_sharding_gathers_for_the_encode(results):
  """A latent step's loss with the frozen VAE sharded over fsdp 4 equals
  the replicated VAE's, bit for bit; each process holds about a quarter
  of it, and a checkpoint holds it whole."""
  for g in results["out"]["vae"]:
    assert float(g["loss_fully_sharded"]) == float(g["loss_replicated"])
    assert int(g["local_replicated"]) == int(g["full_count"])
    assert int(g["local_fully_sharded"]) < 0.3 * int(g["full_count"])
    assert float(g["ckpt_fully_sharded"]) == float(g["ckpt_replicated"]) \
        == float(g["full_sum"])


def test_load_params_reads_a_fully_sharded_run(results):
  from small_vision_tpu_torch.tools import export_sampler
  config = dict(results["config"], **TRAIN_CASES["fully_sharded"])
  params, step, key = export_sampler.load_params(
      config, os.path.join(results["tmp"], "work_fully_sharded"))
  assert (step, key) == (STEPS, "params")
  got = results["out"]["train_fully_sharded"][0]
  flat = dict(tree_flatten_with_names(params))
  assert sorted(flat) == sorted(k[2:] for k in got if k.startswith("p/"))
  for name, t in flat.items():
    np.testing.assert_array_equal(t.numpy(), got[f"p/{name}"])


def test_one_process_checkpoint_restores_fully_sharded(results):
  """The one-process run's step-3 checkpoint in fsdp=4: each process's
  parts, gathered, are the checkpoint's tensors; each holds a quarter of
  the sharded leaves."""
  mngr = ckpt_lib.make_manager(os.path.join(results["tmp"], "work_single"))
  restored = ckpt_lib.restore(mngr)
  params = dict(tree_flatten_with_names(restored["params"]))
  opt = dict(tree_flatten_with_names(restored["opt"]))
  got = results["out"]["restore"]
  for g in got:
    assert int(g["count"]) == STEPS
    for name, t in params.items():
      np.testing.assert_array_equal(g[f"params/{name}"], t.numpy())
      np.testing.assert_array_equal(g[f"mu/{name}"],
                                    opt[f"mu/{name}"].float().numpy())
      np.testing.assert_array_equal(g[f"nu/{name}"], opt[f"nu/{name}"].numpy())
  assert sum(int(g["local"]) for g in got) < 2 * sum(
      t.numel() for t in params.values())


def test_dryrun_multichip_at_4(results):
  log = results["logs"][0]
  assert "mesh={'data': 2, 'fsdp': 2} fully_sharded" in log, log[-2000:]
  assert "mesh={'data': 2, 'pipe': 2} pipeline" in log, log[-2000:]
  assert "mesh={'data': 1, 'fsdp': 2, 'tensor': 2} tp_fsdp" in log, \
      log[-2000:]


def test_processes_ended_within_their_limit(results):
  """The fixture's processes ended within their 120 s; a process that
  outlives its limit is killed and reaped, and the call fails."""
  assert results["seconds"] < 120
  with pytest.raises(TimeoutError) as e:
    dryrun_multichip.spawn("test_torch_parallel_worker:hang", 2, timeout=10,
                           threads=1, env={"PYTHONPATH": TESTS})
  for pid in e.value.pids:
    with pytest.raises(ProcessLookupError):
      os.kill(pid, 0)
