"""One full sharded training step in n processes, on multi-axis meshes.

Counterpart of `__graft_entry__.dryrun_multichip`, for the port: it spawns
n processes joined in a gloo process group (over a `FileStore` in a
temporary directory, so that no port is taken), sharing the card(s)
(process r on card r mod count; the default, `--device cuda`, which raises
where no card is found) or, with `--device cpu`, on the CPU, and in each
runs one training step of a small UMD (width 64, labels, EMA)

  - on a `data` x `fsdp` mesh (fsdp 2), `fully_sharded` with every leaf
    sharded (`min_size_to_shard=0`), and
  - on a `data` x `pipe` mesh (pipe 2), the encoder's and the decoder's
    stacks pipelined (`pipe_stages=2`, 2 microbatches, `pipeline`
    sharding), and
  - where n is a multiple of 4, on a `data` x `fsdp` x `tensor` mesh
    (fsdp 2, tensor 2), `tp_fsdp` (the blocks' projections over `tensor`,
    every other leaf over `fsdp`, `min_size_to_shard=0`), as JAX's
    dryrun does,

through `train_ae.setup_training` and its step, and checks that the loss is
finite, the same on the processes that hold the same rows, and that the
gradient's norm is the same on every process.

  python -m small_vision_tpu_torch.tools.dryrun_multichip --n 4
  python -m small_vision_tpu_torch.tools.dryrun_multichip --n 2 --probe
  python -m small_vision_tpu_torch.tools.dryrun_multichip --n 4 \\
      --device cpu

`--probe` first checks each collective of `parallel.collectives` (the
all-reduce, broadcast, all-gather, reduce-scatter and ppermute, and their
host-staged route) against numpy on the process group's tensors.

`spawn` is the launcher the tests and `chip_smoke.py` use too: every
process has a time limit and is killed on it, which fails the call.
"""

import argparse
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

_MODULE = "small_vision_tpu_torch.tools.dryrun_multichip"
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def spawn(target: str, n: int, *, args=(), device="cpu", timeout=120.0,
          threads=None, log_dir=None, env=None) -> list:
  """Runs `target` ("module:function") as `function(rank, n, *args)` in n
  processes joined in a gloo group; returns their logs.

  Raises when a process fails, or when the processes have not all ended
  within `timeout` seconds (a `TimeoutError` with their `pids`; every
  process is killed and reaped first).
  `threads`: torch's intra-op threads per process (default: the cores
  over n). A process's stdout and stderr go to `log_dir` (default: the
  store's temporary directory).
  """
  with tempfile.TemporaryDirectory(prefix="sv_spawn_") as tmp:
    log_dir = log_dir or tmp
    store = os.path.join(tmp, "store")
    threads = threads or max(1, (os.cpu_count() or 1) // n)
    child_env = dict(os.environ, **(env or {}))
    child_env["PYTHONPATH"] = _REPO + os.pathsep + child_env.get(
        "PYTHONPATH", "")
    procs, logs = [], []
    for rank in range(n):
      spec = json.dumps({"target": target, "rank": rank, "n": n,
                         "store": store, "device": device,
                         "threads": threads, "args": list(args)})
      path = os.path.join(log_dir, f"rank{rank}.log")
      logs.append(path)
      with open(path, "w") as f:
        procs.append(subprocess.Popen(
            [sys.executable, "-m", _MODULE, "--child", spec],
            stdout=f, stderr=subprocess.STDOUT, env=child_env, cwd=_REPO))
    deadline = time.monotonic() + timeout
    try:
      while any(p.poll() is None for p in procs):
        if time.monotonic() > deadline:
          error = TimeoutError(f"{target} on {n} processes did not end "
                               f"within {timeout:.0f} s")
          error.pids = [p.pid for p in procs]
          raise error
        if any(p.poll() not in (None, 0) for p in procs):
          break  # one failed: the others may wait on it for ever
        time.sleep(0.05)
    finally:
      for p in procs:
        if p.poll() is None:
          p.kill()
          p.wait()
    texts = []
    for path in logs:
      with open(path) as f:
        texts.append(f.read())
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
      r = failed[0]
      raise RuntimeError(f"{target}: process {r} of {n} failed "
                         f"(rc {procs[r].returncode}):\n{texts[r][-4000:]}")
    return texts


def _child(spec: str):
  spec = json.loads(spec)
  import torch
  import torch.distributed as dist
  torch.set_num_threads(spec["threads"])
  device = spec["device"]
  if device == "cuda":
    device = f"cuda:{spec['rank'] % torch.cuda.device_count()}"
    torch.cuda.set_device(torch.device(device))
  dist.init_process_group(
      "gloo", store=dist.FileStore(spec["store"], spec["n"]),
      rank=spec["rank"], world_size=spec["n"])
  try:
    module, fn = spec["target"].split(":")
    getattr(importlib.import_module(module), fn)(
        spec["rank"], spec["n"], device, *spec["args"])
  finally:
    dist.destroy_process_group()


def _config(device, labels=True):
  """A small UMD (width 64, 4 heads of 16): f32 on the CPU, bf16 (the
  kernels' type) on the card."""
  from small_vision_tpu_torch.configs import ae_i1k
  config = ae_i1k.get_config("runlocal,size=16,data=synthetic,total_steps=10")
  config["model"].update(
      width=64, depth=2, dec_depth=1, num_heads=4, scan=True,
      dtype_mm="float32" if device == "cpu" else "bfloat16")
  if labels:
    config["model"]["num_classes"] = config["num_classes"] = 10
    config["ema_decay"] = 0.01
  config["diff_schedule"]["timesteps"] = 50
  return config


def probe(rank, n, device):
  """Each collective's result against numpy, on this process group."""
  import numpy as np
  import torch
  import torch.distributed as dist
  from small_vision_tpu_torch.parallel import collectives as c
  group = dist.group.WORLD
  x = torch.arange(8 * n, dtype=torch.float32, device=device).reshape(
      2 * n, 4) + 100 * rank
  every = [np.arange(8 * n, dtype=np.float32).reshape(2 * n, 4) + 100 * r
           for r in range(n)]
  checks = {
      "all_reduce": (c.all_reduce(x.clone(), group), sum(every)),
      "broadcast": (c.broadcast(x.clone(), group, 0), every[0]),
      "all_gather": (c.all_gather(x, group, 1), np.concatenate(every, 1)),
      "reduce_scatter": (c.reduce_scatter(x, group, 0),
                         np.split(sum(every), n, 0)[rank]),
      "ppermute": (c.ppermute(x, group, 1), every[(rank - 1) % n]),
  }
  for name, (got, want) in checks.items():
    got = got.cpu().numpy()
    assert np.array_equal(got, want), (name, got, want)
  if rank == 0:
    print(f"probe: {sorted(checks)} equal to numpy on {n} processes, "
          f"transport {c.transport(group)}", flush=True)


def dryrun(rank, n, device):
  """One training step on a data x fsdp and on a data x pipe mesh."""
  import numpy as np
  import torch
  from small_vision_tpu_torch.parallel import collectives as c
  from small_vision_tpu_torch.parallel import mesh as mesh_lib
  from small_vision_tpu_torch.train import train_ae

  def one_step(config, mesh):
    run = train_ae.setup_training(config, device, lambda s: None, mesh)
    batches = iter(run["train_iter"])
    try:
      meas = run["update_fn"](run["train_state"], next(batches),
                              with_l2=True)
    finally:
      batches.close()
    loss = float(meas["training_loss"])
    mean = float(c.all_reduce(torch.tensor([loss], dtype=torch.float64),
                              mesh.batch_group(), "mean")[0])
    return loss, mean, float(meas["l2_grads"])

  fsdp = 2 if n % 2 == 0 else 1
  config = _config(device)
  config.update(param_sharding="fully_sharded",
                optim_sharding="fully_sharded", min_size_to_shard=0)
  config["input"]["batch_size"] = 2 * n
  mesh = mesh_lib.make_mesh(fsdp=fsdp)
  loss, mean, g = one_step(config, mesh)
  assert np.isfinite(loss) and np.isfinite(g), (loss, g)
  norms = c.process_allgather(np.asarray([g]))
  assert np.all(norms == norms[0]), norms  # one global norm everywhere
  if rank == 0:
    print(f"dryrun_multichip({n}): mesh={mesh.shape} fully_sharded "
          f"loss={mean:.4f} OK", flush=True)
  if n % 2:
    return
  config = _config(device)
  config["model"].update(depth=2, dec_depth=2, pipe_stages=2,
                         pipe_microbatches=2)
  config.update(param_sharding="pipeline", optim_sharding="pipeline")
  config["input"]["batch_size"] = 4 * (n // 2)
  mesh = mesh_lib.make_mesh(data=n // 2, pipe=2)
  loss, mean, g = one_step(config, mesh)
  assert np.isfinite(loss) and np.isfinite(g), (loss, g)
  if rank == 0:
    print(f"dryrun_multichip({n}): mesh={mesh.shape} pipeline "
          f"loss={mean:.4f} OK", flush=True)
  if n % 4:
    return
  config = _config(device)
  config.update(param_sharding="tp_fsdp", optim_sharding="tp_fsdp",
                min_size_to_shard=0, mesh_fsdp=2, mesh_tensor=2)
  config["input"]["batch_size"] = n
  mesh = train_ae.build_mesh(config)
  loss, mean, g = one_step(config, mesh)
  assert np.isfinite(loss) and np.isfinite(g), (loss, g)
  got = c.process_allgather(np.asarray([[loss, g]]))
  assert np.all(got[:, 1] == got[0, 1]), got  # one global norm everywhere
  assert np.all(got[0::2, 0] == got[1::2, 0]), got  # tensor ranks agree
  if rank == 0:
    print(f"dryrun_multichip({n}): mesh={mesh.shape} tp_fsdp "
          f"loss={mean:.4f} OK", flush=True)


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument("--n", type=int, default=4)
  parser.add_argument("--device", default="cuda",
                      help="cuda (the card(s), shared) or cpu")
  parser.add_argument("--probe", action="store_true")
  parser.add_argument("--timeout", type=float, default=300)
  parser.add_argument("--child", default=None, help=argparse.SUPPRESS)
  args = parser.parse_args(argv)
  if args.child:
    return _child(args.child)
  if args.device != "cpu":
    import torch
    if not torch.cuda.is_available():
      raise RuntimeError(f"dryrun_multichip: --device {args.device} needs a "
                         "CUDA device; --device cpu runs on the CPU")
  if args.probe:
    print(spawn(f"{_MODULE}:probe", args.n, device=args.device,
                timeout=args.timeout)[0], end="")
  print(spawn(f"{_MODULE}:dryrun", args.n, device=args.device,
              timeout=args.timeout)[0], end="")


if __name__ == "__main__":
  main()
