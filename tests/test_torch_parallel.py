"""Port parity: the parallel layer in one process, against the JAX package
on conftest's 8 virtual CPU devices.

  - `make_mesh`'s axes and sizes against JAX `make_mesh`'s, over 8
    processes (a layout-only mesh: no process group here), and the
    batch-shard coordinates against JAX's `P(("data", "fsdp"))` rows.
  - the trainer's placements (`make_layout`): `param_sharding` and
    `optim_sharding` in the four combinations of `replicated` and
    `fully_sharded` on UMD-B/4@64's parameters, each leaf's parameter and
    optimizer spec and per-process element count against the JAX
    trainer's `infer_sharding` of its params' and its optax state's
    (`jax.eval_shape(tx.init, ...)`) shapes, mu and nu alike; and
    `vae_param_sharding` on the SD VAE's parameters, each leaf's full and
    per-process element counts against JAX's;
  - `infer_sharding` under all five strategies on a small UMD's parameters
    (unrolled and `scan=True`): each leaf's spec and each process's element
    count against the JAX specs and `NamedSharding.shard_shape` on the
    same mesh, from `jax.eval_shape` of the JAX model.
  - `reshard` / `unshard` of a tree: the blocks of every rank put back
    together are the full tree, bit for bit.
  - `launch.env_rank_size`, `first_host`, `coordinator_address` on the
    environment dicts of tests/test_parallel.py.
  - `utils.misc.pad_shard_unpad` and `accumulate_gradient` against JAX's.
  - `stage_params` / `unstage_params` round trips, `bubble_fraction`.
  - `MixedSource`'s order at process shards 0-3 against the JAX iterator's
    at process indices 0-3.
  - With no process group every collective is the fast path: it returns
    its input, and the sharded helpers leave one process's step alone.
  - `tools/dryrun_multichip.py` runs on the card by default: with no card
    its `main` raises before it starts a process, and `--device cpu`
    starts them on the CPU.
The multi-process checks are in tests/test_torch_parallel_multiproc.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from small_vision_tpu import optim as joptim
from small_vision_tpu import parallel as jparallel
from small_vision_tpu.data import pipeline as jpipeline
from small_vision_tpu.models import ae as jae
from small_vision_tpu.utils import misc as jmisc
from small_vision_tpu_torch import launch
from small_vision_tpu_torch.configs import ae_i1k
from small_vision_tpu_torch.data import core as ds_core
from small_vision_tpu_torch.data import pipeline as tpipeline
from small_vision_tpu_torch.data import synthetic
from small_vision_tpu_torch.parallel import collectives, ctx
from small_vision_tpu_torch.parallel import mesh as mesh_lib
from small_vision_tpu_torch.parallel import pipeline as pl
from small_vision_tpu_torch.parallel import sharding
from small_vision_tpu_torch.train import train_ae
from small_vision_tpu_torch.utils import misc
from small_vision_tpu_torch.utils.trees import tree_flatten_with_names

MESHES = [dict(), dict(fsdp=4), dict(fsdp=0), dict(data=2, fsdp=2, tensor=2),
          dict(data=4, tensor=2), dict(data=2, pipe=4),
          dict(data=1, pipe=2, fsdp=4), dict(fsdp=2, pipe=2)]


@pytest.mark.parametrize("kw", MESHES)
def test_make_mesh_matches_jax(kw):
  got = mesh_lib.make_mesh(8, **kw)
  want = jparallel.make_mesh(**kw)
  assert got.axis_names == tuple(want.axis_names)
  assert got.shape == dict(want.shape)
  assert got.layout_only
  # The rows of the global batch each rank holds: JAX's P(("data",
  # "fsdp")) on the mesh's devices, device i being rank i.
  spec = jparallel.batch_sharding(want)
  b = 16 * 8
  idx = spec.devices_indices_map((b,))
  for rank in range(8):
    index, count = got.batch_shard(rank)
    rows = idx[jax.devices()[rank]][0]
    start = rows.start or 0
    stop = b if rows.stop is None else rows.stop
    assert (start, stop) == (index * b // count, (index + 1) * b // count)


def test_one_process_mesh_has_no_groups():
  mesh = mesh_lib.make_mesh()
  assert mesh.shape == {"data": 1} and not mesh.layout_only
  assert mesh.group("data") is None and mesh.batch_group() is None
  assert mesh.batch_shard() == (0, 1)
  assert mesh_lib.local_mesh_info(mesh) == (1, 1, 1)


def _small_config(scan):
  config = ae_i1k.get_config("runlocal,size=16,data=synthetic")
  config["model"].update(scan=scan, dtype_mm="float32", num_classes=10)
  config["num_classes"] = 10
  return config


def _trees(scan):
  """(the port's {name: parameter} of the small UMD, JAX's shapes)."""
  config = _small_config(scan)
  model = train_ae.build_model(config, device="meta")
  port = dict(train_ae.named_params(model))
  shapes = jax.eval_shape(lambda: jae.Model(**config["model"]).init(
      jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
      t=jnp.zeros((1,), jnp.int32), y=jnp.zeros((1,), jnp.int32)))
  return port, shapes["params"]


STRATEGIES = [("replicated", dict(fsdp=4)),
              ("fully_sharded", dict(fsdp=4)),
              ("fully_sharded", dict()),
              ("fully_sharded", dict(data=2, fsdp=2, tensor=2)),
              ("tensor_parallel", dict(data=4, tensor=2)),
              ("tp_fsdp", dict(data=2, fsdp=2, tensor=2)),
              ("pipeline", dict(data=4, pipe=2))]


@pytest.mark.parametrize("strategy,kw,scan", [
    (s, kw, scan) for s, kw in STRATEGIES for scan in (False, True)
    if scan or s != "pipeline"])  # the pipeline shards scan=True stacks
def test_infer_sharding_matches_jax(strategy, kw, scan):
  """Every leaf's spec and per-process element count equal JAX's
  (min_size_to_shard 0 where the strategy takes it, so that the small
  model's leaves shard)."""
  port, jtree = _trees(scan)
  extra = ({"min_size_to_shard": 0}
           if strategy in ("fully_sharded", "tp_fsdp") else {})
  mesh = mesh_lib.make_mesh(8, **kw)
  jmesh = jparallel.make_mesh(**kw)
  got = sharding.infer_sharding(port, mesh, strategy, **extra)
  want = dict(tree_flatten_with_names(
      jax.tree.map(lambda s: s, jparallel.infer_sharding(
          jtree, jmesh, strategy, **extra),
          is_leaf=lambda s: isinstance(s, NamedSharding))))
  jshapes = dict(tree_flatten_with_names(jtree))
  assert sorted(got) == sorted(want)
  sharded = 0
  for name, spec in got.items():
    jspec = tuple(want[name].spec)
    assert spec == jspec + (None,) * (len(spec) - len(jspec)) if spec else \
        not any(jspec), (name, spec, jspec)
    local = sharding.shard_shape(port[name].shape, spec, mesh)
    jlocal = want[name].shard_shape(jshapes[name].shape)
    assert int(np.prod(local)) == int(np.prod(jlocal)), (name, local, jlocal)
    sharded += local != tuple(port[name].shape)
  if strategy != "replicated":
    assert sharded, "no leaf sharded"


def test_reshard_and_unshard_round_trip():
  """The ranks' blocks of a fully_sharded tree, put back together on their
  dims, are the tree; `unshard` of one process's tree is the identity."""
  port, _ = _trees(True)
  rng = np.random.default_rng(0)
  full = {n: torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(
      np.float32)) for n, p in port.items()}
  mesh = mesh_lib.make_mesh(8, fsdp=4)
  specs = sharding.infer_sharding(full, mesh, "fully_sharded",
                                  min_size_to_shard=0)
  blocks = [sharding.reshard(full, specs, mesh, rank) for rank in range(8)]
  for name, t in full.items():
    hit = sharding.spec_axis(specs[name])
    if hit is None:
      assert all(b[name] is t for b in blocks)
      continue
    dim, axis = hit
    ranks = [r for r in range(8) if mesh.coord("data", r) == 0]
    back = torch.cat([blocks[r][name] for r in ranks], dim)
    assert torch.equal(back, t), name
  one = mesh_lib.make_mesh()
  assert sharding.unshard(full, (), one) == full


def _clear_launcher_env(monkeypatch):
  import os
  for k in list(os.environ):
    if k.startswith(("OMPI_", "SLURM_", "PMI_")) or k == "SV_COORDINATOR_ADDRESS":
      monkeypatch.delenv(k, raising=False)


def test_launch_env_rank_discovery(monkeypatch):
  """The environment dicts of tests/test_parallel.py, through the port's
  launch helpers and the JAX package's alike."""
  from small_vision_tpu import launch as jlaunch
  _clear_launcher_env(monkeypatch)
  assert launch.env_rank_size() is None is jlaunch.env_rank_size()
  monkeypatch.setenv("OMPI_COMM_WORLD_RANK", "3")
  monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "8")
  monkeypatch.setenv("OMPI_COMM_WORLD_LOCAL_RANK", "1")
  assert launch.env_rank_size() == (3, 8, 1) == jlaunch.env_rank_size()
  monkeypatch.delenv("OMPI_COMM_WORLD_RANK")
  monkeypatch.delenv("OMPI_COMM_WORLD_SIZE")
  monkeypatch.setenv("SLURM_PROCID", "5")
  monkeypatch.setenv("SLURM_NTASKS", "16")
  assert launch.env_rank_size() == (5, 16, 0) == jlaunch.env_rank_size()
  monkeypatch.setenv("SLURM_NODELIST", "node[003-008,011]")
  assert launch.coordinator_address(29500) == "node003:29500"
  for nodes in ("a1,b2", "gpu-07", "node[003-008,011]", "x[1-2]"):
    assert launch.first_host(nodes) == jlaunch.first_host(nodes)
  monkeypatch.setenv("SV_COORDINATOR_ADDRESS", "10.0.0.1")
  assert launch.coordinator_address(29500) == "10.0.0.1:29500"
  monkeypatch.setenv("SV_COORDINATOR_ADDRESS", "10.0.0.1:4000")
  assert launch.coordinator_address(29500) == "10.0.0.1:4000"
  assert (launch.coordinator_address(1) == jlaunch.coordinator_address(1))
  monkeypatch.delenv("SV_COORDINATOR_ADDRESS")
  monkeypatch.delenv("SLURM_NODELIST")
  with pytest.raises(RuntimeError, match="SV_COORDINATOR_ADDRESS"):
    launch.coordinator_address(29500)


def test_one_process_needs_no_process_group(monkeypatch):
  """Without a launcher `init_distributed` does nothing, and a launcher
  world of one joins nothing either."""
  _clear_launcher_env(monkeypatch)
  mesh_lib.init_distributed(device="cpu")
  assert not mesh_lib.is_distributed()
  monkeypatch.setenv("SLURM_PROCID", "0")
  monkeypatch.setenv("SLURM_NTASKS", "1")
  mesh_lib.init_distributed(device="cpu")
  assert not mesh_lib.is_distributed()
  assert launch.backend_for("cpu") == "gloo"
  assert launch.backend_for("cuda") == "nccl"


@pytest.mark.parametrize("b,min_device_batch", [(13, None), (16, None),
                                                (3, 4)])
def test_pad_shard_unpad_matches_jax(b, min_device_batch):
  """Rows padded to a multiple of the shard count (8, JAX's device count
  here), the function sees the padded batch, the outputs are cut back."""
  seen = {}

  def fn(scale, x):
    seen.setdefault("shapes", []).append(x.shape[0])
    return {"y": x * scale, "s": x.sum()}

  x = np.arange(b * 3, dtype=np.float32).reshape(b, 3)
  want = jmisc.pad_shard_unpad(
      lambda scale, x: fn(scale, np.asarray(x)))(
          2.0, x, min_device_batch=min_device_batch)
  got = misc.pad_shard_unpad(fn, num_shards=jax.device_count())(
      2.0, torch.from_numpy(x), min_device_batch=min_device_batch)
  assert seen["shapes"][0] == seen["shapes"][1]
  np.testing.assert_array_equal(got["y"].numpy(), np.asarray(want["y"]))
  np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))


def test_accumulate_gradient_matches_jax():
  """4 microbatches: the mean loss and gradients, f32, within 1e-6."""
  rng = np.random.default_rng(1)
  w = rng.standard_normal((5, 3)).astype(np.float32)
  x = rng.standard_normal((16, 5)).astype(np.float32)
  y = rng.standard_normal((16, 3)).astype(np.float32)

  def jloss(p, batch):
    return jnp.mean((batch["x"] @ p - batch["y"]) ** 2)

  def tloss_grad(p, batch):
    p = p.clone().requires_grad_(True)
    loss = torch.mean((batch["x"] @ p - batch["y"]) ** 2)
    return loss.detach(), torch.autograd.grad(loss, p)[0]

  jl, jg = jmisc.accumulate_gradient(jax.value_and_grad(jloss), w,
                                     {"x": x, "y": y}, 4)
  tl, tg = misc.accumulate_gradient(
      tloss_grad, torch.from_numpy(w),
      {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, 4)
  np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
  np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                             atol=1e-6)
  full_l, full_g = misc.accumulate_gradient(
      tloss_grad, torch.from_numpy(w),
      {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, 1)
  np.testing.assert_allclose(tg.numpy(), full_g.numpy(), rtol=1e-5,
                             atol=1e-6)


def test_stage_roundtrip():
  rng = np.random.default_rng(2)
  stacked = {"w": torch.from_numpy(rng.standard_normal((8, 4, 4))),
             "b": {"c": torch.from_numpy(rng.standard_normal((8, 4)))}}
  staged = pl.stage_params(stacked, 4)
  assert staged["w"].shape == (4, 2, 4, 4)
  assert staged["b"]["c"].shape == (4, 2, 4)
  back = pl.unstage_params(staged)
  assert torch.equal(back["w"], stacked["w"])
  assert torch.equal(back["b"]["c"], stacked["b"]["c"])
  assert pl.staged_param_specs(staged)["w"] == ("pipe", None, None, None)
  with pytest.raises(AssertionError, match="not divisible"):
    pl.stage_params(stacked, 3)


def test_bubble_fraction():
  from small_vision_tpu.parallel import pipeline as jpl
  for s, m in ((1, 4), (4, 13), (2, 8), (8, 32)):
    assert pl.bubble_fraction(s, m) == jpl.bubble_fraction(s, m)
  assert pl.bubble_fraction(2, 8) == pytest.approx(1 / 9)


def _mixed_ids(make, n):
  out = []
  for ex in make():
    out.append((int(ex["_id"]), int(ex["_mix"])))
    if len(out) == n:
      return out


@pytest.mark.parametrize("index", [0, 1, 2, 3])
def test_mixed_source_order_matches_jax_per_process(index, monkeypatch):
  """The mixture's (seed, epoch, process) draws and each source's process
  shard, at process `index` of 4, against the JAX MixedSource with
  `jax.process_index()` = index and `jax.process_count()` = 4."""
  from small_vision_tpu.data import synthetic as jsynthetic
  monkeypatch.setattr(jax, "process_index", lambda: index)
  monkeypatch.setattr(jax, "process_count", lambda: 4)
  kw = [dict(img_size=8, num_examples=40, pool=8),
        dict(img_size=8, num_examples=24, pool=8, seed=3)]
  want = _mixed_ids(lambda: jpipeline.MixedSource(
      [jsynthetic.DataSource(**k) for k in kw], [2.0, 1.0]).examples(
          seed=5, epoch=1), 60)
  ds_core.set_process_shard(index, 4)
  try:
    got = _mixed_ids(lambda: tpipeline.MixedSource(
        [synthetic.DataSource(**k) for k in kw], [2.0, 1.0]).examples(
            seed=5, epoch=1), 60)
  finally:
    ds_core.set_process_shard(None)
  assert got == want


def test_collectives_fast_path_without_a_process_group():
  x = torch.arange(6.0).reshape(2, 3)
  for fn in (lambda: collectives.all_reduce(x, None),
             lambda: collectives.all_gather(x, None, 1),
             lambda: collectives.reduce_scatter(x, None, 0),
             lambda: collectives.broadcast(x, None),
             lambda: collectives.ppermute(x, None),
             lambda: collectives.gather(x, None),
             lambda: collectives.scatter(x, None),
             lambda: collectives.ppermute_grad(x, None),
             lambda: collectives.sum_grad_identity(x, None)):
    assert fn() is x
  assert collectives.identity_grad_sum(None, x)[0] is x
  assert collectives.transport(None) == "local"
  a = np.arange(4.0)
  np.testing.assert_array_equal(collectives.process_allgather(a), a)
  np.testing.assert_array_equal(collectives.fetch_global({"a": a})["a"], a)
  assert collectives.broadcast_one_to_all(a) is a
  assert collectives.gather_metrics(np.float32(2.5)) == 2.5
  np.testing.assert_array_equal(collectives.all_reduce_host([1.0, 2.0]),
                                [1.0, 2.0])
  misc.sync()


def test_constrain_is_an_identity_that_checks_names():
  x = torch.zeros(2, 3)
  assert ctx.constrain(x, "batch") is x  # no mesh: nothing checked
  with ctx.activate_mesh(mesh_lib.make_mesh()):
    assert ctx.current_mesh() is not None
    assert ctx.constrain(x, "batch", "embed") is x
    with pytest.raises(AssertionError):
      ctx.constrain(x, "batch")
  assert ctx.current_mesh() is None


def test_trainer_refuses_a_pipeline_on_a_tensor_axis():
  """The JAX trainer builds no mesh with both a pipe and a tensor axis; a
  pipeline's optimizer state follows its stages; every combination of the
  other strategies runs."""
  config = dict(_small_config(True), mesh_tensor=2,
                param_sharding="pipeline", optim_sharding="pipeline")
  with pytest.raises(NotImplementedError, match="ROADMAP.md"):
    train_ae.check_parallel_config(config)
  config = _small_config(True)
  config["model"]["pipe_stages"] = 2
  with pytest.raises(NotImplementedError, match="ROADMAP.md"):
    train_ae.check_parallel_config(dict(config, mesh_tensor=2))
  with pytest.raises(ValueError, match="optim_sharding"):
    train_ae.check_parallel_config(dict(
        _small_config(False), param_sharding="pipeline"))
  strategies = ("replicated", "fully_sharded", "tensor_parallel", "tp_fsdp")
  for p in strategies:
    for o in strategies:
      assert train_ae.check_parallel_config(dict(
          _small_config(False), param_sharding=p, optim_sharding=o)) == (
              p, o, "replicated")
  assert train_ae.check_parallel_config(_small_config(False)) == (
      "replicated", "replicated", "replicated")


@pytest.fixture(scope="module")
def umd_b4():
  """(the port's UMD-B/4@64 on the meta device, JAX's params' shapes and
  its optax state's shapes, as the JAX trainer makes them)."""
  config = ae_i1k.get_config("size=64,data=synthetic")
  model = train_ae.build_model(config, device="meta")
  kw = dict(config["model"], attn_impl="xla")
  params = jax.eval_shape(lambda: jae.Model(**kw).init(
      jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
      t=jnp.zeros((1,), jnp.int32)))["params"]
  tx, _ = joptim.adamw_trainer_tx(peak_lr=1e-4, batch_size=256,
                                  total_steps=10, warmup_steps=1, wd=0.05)
  return model, params, jax.eval_shape(tx.init, params)


def _named_specs(tree):
  return {n: tuple(s.spec) for n, s in tree_flatten_with_names(jax.tree.map(
      lambda s: s, tree, is_leaf=lambda s: isinstance(s, NamedSharding)))}


def _spec_eq(port, jspec):
  return port == jspec + (None,) * (len(port) - len(jspec)) if port else \
      not any(jspec)


@pytest.mark.parametrize("kw", [dict(fsdp=4), dict(data=2, fsdp=4)])
@pytest.mark.parametrize("param_s,optim_s", [
    (p, o) for p in ("replicated", "fully_sharded")
    for o in ("replicated", "fully_sharded")])
def test_trainer_placements_match_jax(umd_b4, kw, param_s, optim_s):
  """The trainer's layout for each combination: every leaf's parameter
  spec against JAX `infer_sharding(params_shape, ...)` and its optimizer
  spec against JAX's of the optax state's mu and nu
  (`train_ae.py:455-458`), and each one's per-process element count."""
  model, jparams, jopt = umd_b4
  mesh = mesh_lib.make_mesh(8, **kw)
  jmesh = jparallel.make_mesh(**kw)
  config = {"param_sharding": param_s, "optim_sharding": optim_s}
  layout = train_ae.make_layout(config, mesh, train_ae.named_params(model))
  want_p = _named_specs(jparallel.infer_sharding(jparams, jmesh, param_s))
  adam = [s for s in jax.tree.leaves(
      jparallel.infer_sharding(jopt, jmesh, optim_s),
      is_leaf=lambda x: hasattr(x, "mu") and hasattr(x, "nu"))
          if hasattr(s, "mu")]
  assert len(adam) == 1
  want_mu, want_nu = _named_specs(adam[0].mu), _named_specs(adam[0].nu)
  assert sorted(want_p) == sorted(layout.names) == sorted(want_mu)
  shapes = dict(tree_flatten_with_names(jparams))
  local_p = local_o = 0
  for i, name in enumerate(layout.names):
    assert _spec_eq(layout.specs[i], want_p[name]), name
    assert _spec_eq(layout.opt_specs[i], want_mu[name]), name
    assert want_mu[name] == want_nu[name], name
    full = shapes[name].shape
    for spec, jspec in ((layout.specs[i], want_p[name]),
                        (layout.opt_specs[i], want_mu[name])):
      assert int(np.prod(sharding.shard_shape(full, spec, mesh))) == int(
          np.prod(NamedSharding(jmesh, jax.sharding.PartitionSpec(*jspec))
                  .shard_shape(full))), name
    local_p += int(np.prod(sharding.shard_shape(full, layout.specs[i], mesh)))
    local_o += int(np.prod(layout.opt_shapes()[i]))
  total = sum(int(np.prod(s.shape)) for s in shapes.values())
  for local, strategy in ((local_p, param_s), (local_o, optim_s)):
    assert local == total if strategy == "replicated" else local < total / 3
  assert layout.keeps_full_for_update == (
      (param_s, optim_s) == ("fully_sharded", "replicated"))


@pytest.mark.parametrize("strategy", ["replicated", "fully_sharded"])
def test_vae_placement_matches_jax(strategy):
  """`vae_param_sharding` on the SD VAE (meta tensors): each leaf's full
  and per-process element counts, as a multiset, against JAX's on the
  flax tree (the port keeps torch's OIHW kernels, so leaves pair by size,
  not by name)."""
  from small_vision_tpu.models import vae as jvae
  from small_vision_tpu_torch.models import vae as tvae
  with torch.device("meta"):
    port = dict(tvae.AutoencoderKL().state_dict())
  jtree = jax.eval_shape(lambda: jvae.AutoencoderKL().init(
      jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))["params"]
  mesh = mesh_lib.make_mesh(8, fsdp=4)
  jmesh = jparallel.make_mesh(fsdp=4)
  specs = sharding.infer_sharding(port, mesh, strategy)
  got = sorted((t.numel(), int(np.prod(sharding.shard_shape(
      t.shape, specs[n], mesh)))) for n, t in port.items())
  jspecs = dict(tree_flatten_with_names(jax.tree.map(
      lambda s: s, jparallel.infer_sharding(jtree, jmesh, strategy),
      is_leaf=lambda s: isinstance(s, NamedSharding))))
  want = sorted((int(np.prod(s.shape)), int(np.prod(
      jspecs[n].shard_shape(s.shape)))) for n, s in
      tree_flatten_with_names(jtree))
  assert got == want
  assert any(a != b for a, b in got) == (strategy == "fully_sharded")


def _jax_shardings(tree):
  return dict(tree_flatten_with_names(jax.tree.map(
      lambda s: s, tree, is_leaf=lambda s: isinstance(s, NamedSharding))))


@pytest.mark.parametrize("extra", [
    {"param_sharding": "tensor_parallel", "mesh_tensor": 2},
    {"param_sharding": "tp_fsdp", "optim_sharding": "tp_fsdp",
     "mesh_fsdp": 2, "mesh_tensor": 2},
    {"vae_param_sharding": "tensor_parallel", "mesh_tensor": 2},
    {"mesh_tensor": 2}], ids=["tensor_parallel", "tp_fsdp", "vae", "mesh"])
def test_trainer_places_tensor_parallelism_as_jax(umd_b4, extra):
  """The four configs the trainer refused before tensor parallelism was
  ported: each now builds a layout on 8 processes whose every leaf's
  parameter and optimizer spec, and per-process element count, is JAX's
  `infer_sharding` on the same mesh (data x fsdp x tensor of 8 devices)."""
  model, jparams, _ = umd_b4
  config = dict(ae_i1k.get_config("size=64,data=synthetic"), **extra)
  p_s, o_s, v_s = train_ae.check_parallel_config(config)
  assert (p_s, o_s, v_s) == (extra.get("param_sharding", "replicated"),
                             extra.get("optim_sharding", "replicated"),
                             extra.get("vae_param_sharding", "replicated"))
  sizes = dict(fsdp=int(config.get("mesh_fsdp", 1)),
               tensor=int(config.get("mesh_tensor", 1)))
  mesh = mesh_lib.make_mesh(8, **sizes)
  assert mesh.shape == dict(jparallel.make_mesh(**sizes).shape)
  layout = train_ae.make_layout(config, mesh, train_ae.named_params(model))
  jmesh = jparallel.make_mesh(**sizes)
  flat = dict(tree_flatten_with_names(jparams))
  for strategy, specs in ((p_s, layout.specs), (o_s, layout.opt_specs)):
    want = _jax_shardings(jparallel.infer_sharding(jparams, jmesh,
                                                   strategy))
    for name, spec in zip(layout.names, specs):
      jspec = tuple(want[name].spec)
      assert spec == jspec + (None,) * (len(spec) - len(jspec)) \
          if spec else not any(jspec), (strategy, name, spec, jspec)
      assert int(np.prod(sharding.shard_shape(flat[name].shape, spec,
                                              mesh))) == int(np.prod(
          want[name].shard_shape(flat[name].shape))), (strategy, name)
  tp_leaves = [n for n, s in zip(layout.names, layout.specs)
               if "tensor" in s]
  assert bool(tp_leaves) == (p_s in ("tensor_parallel", "tp_fsdp"))
  if v_s == "tensor_parallel":  # no rule matches a VAE name: replicated
    from small_vision_tpu.models import vae as jvae
    from small_vision_tpu_torch.models import vae as tvae
    with torch.device("meta"):
      port = dict(tvae.AutoencoderKL().state_dict())
    specs = sharding.infer_sharding(port, mesh, v_s)
    assert all(s == sharding.REPLICATED for s in specs.values())
    jtree = jax.eval_shape(lambda: jvae.AutoencoderKL().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))["params"]
    assert not any(any(s.spec) for s in _jax_shardings(
        jparallel.infer_sharding(jtree, jmesh, v_s)).values())


def test_dryrun_tool_runs_on_the_card_or_raises(monkeypatch):
  from small_vision_tpu_torch.tools import dryrun_multichip
  calls = []
  monkeypatch.setattr(
      dryrun_multichip, "spawn",
      lambda target, n, **kw: calls.append((target, kw)) or [""])
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="--device cuda needs a CUDA device"):
    dryrun_multichip.main([])
  assert not calls  # nothing ran, on the CPU or elsewhere
  dryrun_multichip.main(["--device", "cpu", "--n", "2"])
  assert [(t.rsplit(":", 1)[1], kw["device"]) for t, kw in calls] == [
      ("dryrun", "cpu")]
