"""Where the time of one training step goes on the GPU.

  python -m small_vision_tpu_torch.tools.profile_train [--batch 256]
      [--config ae_i1k.py:attn_impl=pallas_fused]
      [--config ae_i1k.py:ckpt_steps=1,eval_steps=1] [--eval_batches 2]

Sets up the UMD-B/4@64 training run as `train_and_evaluate` does
(synthetic data, `init_train_params` weights, AdamW, device pp), takes two
warm-up steps, times `--steps` steps without the profiler, then traces one
step with torch.profiler and prints, with the card's name and power limit:
  - the mean wall time of a step and img/s without the profiler;
  - the device-busy time of the traced step (the union of kernel
    intervals), and its share of the untraced step's wall time;
  - device time by class: matmuls, the port's kernels K1-K6, the
    optimizer (every kernel launched inside the step's "optimizer" range:
    the clip, AdamW and EMA), and the other elementwise kernels;
  - the ten kernels that take the most device time.
With `ckpt_steps=` in `--config` the traced step is followed, inside the
trace, by one checkpoint `save` (into a temporary directory), and with a
positive `eval_steps=` by one run of the config's evaluators cut to
`--eval_batches` batches each. Their device time shows as the classes
"checkpoint" (the copies to host memory) and "evaluator" (every kernel
launched inside an evaluator's run, whatever its own class would be).
"""

import argparse
import collections
import json
import re
import shutil
import tempfile
import time

import torch

from small_vision_tpu_torch.tools.profile_sampler import (busy_us, card_line,
                                                          kernel_events,
                                                          trace_events)

CLASSES = (
    ("K1 ln_modulate_fwd", re.compile(r"ln_modulate_fwd_kernel")),
    ("K2 ln_modulate_bwd", re.compile(r"ln_bwd_rows|ln_bwd_finish")),
    ("K3 attention_packed_fwd", re.compile(r"attention_packed_fwd_kernel")),
    ("K4 attention_packed_bwd", re.compile(r"attn_bwd_dq|attn_bwd_dkdv")),
    ("K5 fused_mlp_fwd", re.compile(r"fused_mlp_kernel")),
    ("K6 fused_mha_fwd", re.compile(r"fused_mha_heads|fused_mha_out_proj")),
    ("matmul", re.compile(r"gemm|xmma|cutlass|nvjet|cublas", re.I)),
)


def classify(name: str, in_optimizer: bool) -> str:
  for cls, pattern in CLASSES:
    if pattern.search(name):
      return cls
  return "optimizer" if in_optimizer else "other elementwise"


def range_correlations(events, range_name: str) -> set:
  """Correlation ids of the launches (kernels and copies) made inside a host
  range named `range_name` (the launch's runtime call starts within the
  range)."""
  ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("name") == range_name and e.get("cat") in
            ("user_annotation", "cpu_op") and "dur" in e]
  out = set()
  for e in events:
    # Launch calls: PyTorch's go through the CUDA runtime, cuBLAS's below
    # it; the trace files both under a category that starts with "cuda_".
    if not e.get("cat", "").startswith("cuda_") or (
        "correlation" not in e.get("args", {})):
      continue
    if any(s <= e["ts"] <= t for s, t in ranges):
      out.add(e["args"]["correlation"])
  return out


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument("--batch", type=int, default=256)
  parser.add_argument("--steps", type=int, default=5)
  parser.add_argument("--config", default="ae_i1k.py:variant=B/4,size=64",
                      help="add attn_impl=pallas_fused for the fused kernels")
  parser.add_argument("--eval_batches", type=int, default=2)
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    raise SystemExit("profile_train: needs a CUDA device")

  from small_vision_tpu_torch.configs import parse_config
  from small_vision_tpu_torch.train import train_ae

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  card = card_line()
  with_ckpt = "ckpt_steps=" in args.config
  with_evals = "eval_steps=" in args.config
  config = parse_config(f"{args.config}{',' if ':' in args.config else ':'}"
                        f"batch_size={args.batch},total_steps=1000"
                        + ("" if with_evals else ",eval_steps=-1"))
  run = train_ae.setup_training(config, device="cuda")
  update_fn, state, batches = (run["update_fn"], run["train_state"],
                               run["batches_from"](0))
  evaluators, ckpt_dir, mngr = [], None, None
  if with_evals and config["evals"]:
    from small_vision_tpu_torch.evaluators import common as eval_common
    for ev in config["evals"].values():
      if "data" in ev:
        ev["num_batches"] = args.eval_batches
      else:  # a sampling evaluator: one call
        ev["total_samples"] = 1
    evaluators = eval_common.from_config(
        config, train_ae.make_eval_fns(run["model"], config), "cuda")
  if with_ckpt:
    from small_vision_tpu_torch.utils import checkpoint as ckpt_lib
    from small_vision_tpu_torch.utils.chrono import Chrono
    ckpt_dir = tempfile.mkdtemp(prefix="sv_profile_ckpt_")
    mngr = ckpt_lib.make_manager(ckpt_dir)
    chrono = Chrono(device="cuda")

  def step():
    update_fn(state, next(batches))
    torch.cuda.synchronize()

  for _ in range(2):  # warm-up: kernel builds, cuBLAS handles, allocator
    step()
  t0 = time.perf_counter()
  for _ in range(args.steps):
    step()
  step_s = (time.perf_counter() - t0) / args.steps

  acts = [torch.profiler.ProfilerActivity.CPU,
          torch.profiler.ProfilerActivity.CUDA]
  try:
    with torch.profiler.profile(activities=acts) as prof:
      t0 = time.perf_counter()
      step()
      wall_s = time.perf_counter() - t0
      if mngr is not None:
        with torch.profiler.record_function("checkpoint"):
          ckpt_lib.save(mngr, train_ae.checkpoint_state(
              state, run["names"], chrono), 1)
        torch.cuda.synchronize()
      for (_, evaluator, _, _) in evaluators:
        with torch.profiler.record_function("evaluator"):
          for _ in evaluator.run(state):
            pass
        torch.cuda.synchronize()
    if mngr is not None:
      ckpt_lib.wait_until_finished(mngr)
  finally:
    if ckpt_dir:
      shutil.rmtree(ckpt_dir, ignore_errors=True)
  events = trace_events(prof)
  kernels = kernel_events(prof, events)
  if not kernels:
    raise SystemExit("profile_train: the trace holds no kernel events")
  in_opt = range_correlations(events, "optimizer")
  in_ckpt = range_correlations(events, "checkpoint")
  in_eval = range_correlations(events, "evaluator")
  correlation = lambda e: e.get("args", {}).get("correlation")
  # The checkpoint's work on the device is copies to the host, not kernels.
  kernels += [e for e in events if e.get("cat") == "gpu_memcpy" and "dur" in e
              and correlation(e) in in_ckpt]

  by_class = collections.Counter()
  count = collections.Counter()
  by_name = collections.Counter()
  for e in kernels:
    if correlation(e) in in_ckpt:
      cls = "checkpoint"
    elif correlation(e) in in_eval:
      cls = "evaluator"
    else:
      cls = classify(e["name"], correlation(e) in in_opt)
    by_class[cls] += e["dur"]
    count[cls] += 1
    by_name[e["name"]] += e["dur"]
  # Busy time and kernel count are the step's own: what ran after it (the
  # checkpoint's copies, the evaluators) shows in its class alone.
  after_step = in_ckpt | in_eval
  kernels = [e for e in kernels if correlation(e) not in after_step]
  busy = busy_us((e["ts"], e["ts"] + e["dur"]) for e in kernels) / 1e6
  kernel_s = sum(by_class.values()) / 1e6
  summary = {
      "card": card, "config": args.config, "batch": args.batch,
      "step_s": step_s,
      "img_per_s": args.batch / step_s, "profiled_wall_s": wall_s,
      "kernels": len(kernels), "device_busy_s": busy,
      "device_busy_share": busy / step_s,
      "classes": {c: {"s": by_class[c] / 1e6, "launches": count[c],
                      "share_of_kernel_time": by_class[c] / 1e6 / kernel_s}
                  for c in sorted(by_class)},
      "top": [{"name": n[:120], "s": t / 1e6}
              for n, t in by_name.most_common(10)],
  }
  print(f"[profile] {card}: {args.config}: one training step at batch "
        f"{args.batch}: "
        f"{step_s * 1e3:.2f} ms wall ({args.batch / step_s:.2f} img/s; "
        f"{wall_s * 1e3:.2f} ms under the profiler), {len(kernels)} kernels, "
        f"device busy {busy * 1e3:.2f} ms ({busy / step_s:.1%} of the "
        "unprofiled step)", flush=True)
  for c, v in summary["classes"].items():
    print(f"[profile]   {c:24s} {v['s'] * 1e3:9.3f} ms in {v['launches']:5d} "
          f"launches ({v['share_of_kernel_time']:.1%} of kernel time)",
          flush=True)
  print(json.dumps(summary), flush=True)


if __name__ == "__main__":
  main()
