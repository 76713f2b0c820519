"""Where the time of one training step goes on the GPU.

  python -m small_vision_tpu_torch.tools.profile_train [--batch 256]
      [--config ae_i1k.py:attn_impl=pallas_fused]

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
"""

import argparse
import collections
import json
import re
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


def optimizer_correlations(events) -> set:
  """Correlation ids of the kernel launches made inside a host range named
  "optimizer" (the launch's runtime call starts within the range)."""
  ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("name") == "optimizer" and e.get("cat") in
            ("user_annotation", "cpu_op") and "dur" in e]
  out = set()
  for e in events:
    if e.get("cat") != "cuda_runtime" or "correlation" not in e.get("args",
                                                                   {}):
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
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    raise SystemExit("profile_train: needs a CUDA device")

  from small_vision_tpu_torch.configs import parse_config
  from small_vision_tpu_torch.train import train_ae

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  card = card_line()
  config = parse_config(f"{args.config}{',' if ':' in args.config else ':'}"
                        f"batch_size={args.batch},total_steps=1000")
  run = train_ae.setup_training(config, device="cuda")
  update_fn, state, batches = (run["update_fn"], run["train_state"],
                               run["batches"])

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
  with torch.profiler.profile(activities=acts) as prof:
    t0 = time.perf_counter()
    step()
    wall_s = time.perf_counter() - t0
  events = trace_events(prof)
  kernels = kernel_events(prof, events)
  if not kernels:
    raise SystemExit("profile_train: the trace holds no kernel events")
  in_opt = optimizer_correlations(events)

  by_class = collections.Counter()
  count = collections.Counter()
  by_name = collections.Counter()
  for e in kernels:
    cls = classify(e["name"],
                   e.get("args", {}).get("correlation") in in_opt)
    by_class[cls] += e["dur"]
    count[cls] += 1
    by_name[e["name"]] += e["dur"]
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
