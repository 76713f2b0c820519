"""Where the time of one sampler call goes on the GPU.

  python -m small_vision_tpu_torch.tools.profile_sampler [--batch 64]

Builds the UMD-B/4@64 `uncond_eps` sampler from weights drawn with seed 0
(as chip_smoke.py does), makes one warm-up call, then traces one call with
torch.profiler and prints, with the card's name and power limit:
  - the wall time and img/s of one call without the profiler;
  - the device-busy time of the traced call (the union of kernel
    intervals), and its share of the untraced call's wall time;
  - device time by class: the port's two kernels, matmuls, the rest;
  - the ten kernels that take the most device time.
The trace is parsed from the profiler's Chrome-trace export, written to a
temporary file and deleted.
"""

import argparse
import collections
import json
import os
import re
import subprocess
import tempfile
import time

import torch

CLASSES = (
    ("ln_modulate_fwd", re.compile(r"ln_modulate_fwd_kernel")),
    ("attention_packed_fwd", re.compile(r"attention_packed_fwd_kernel")),
    ("matmul", re.compile(r"gemm|xmma|cutlass|nvjet|cublas", re.I)),
)


def classify(name: str) -> str:
  for cls, pattern in CLASSES:
    if pattern.search(name):
      return cls
  return "other"


def busy_us(intervals) -> float:
  """Length of the union of (start, end) intervals."""
  total, end = 0.0, float("-inf")
  for s, e in sorted(intervals):
    if s > end:
      total += e - s
      end = e
    elif e > end:
      total += e - end
      end = e
  return total


def kernel_events(prof):
  fd, path = tempfile.mkstemp(suffix=".json")
  os.close(fd)
  try:
    prof.export_chrome_trace(path)
    with open(path) as f:
      trace = json.load(f)
  finally:
    os.remove(path)
  return [e for e in trace.get("traceEvents", [])
          if e.get("cat") == "kernel" and "dur" in e]


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument("--batch", type=int, default=64)
  parser.add_argument("--config", default="ae_i1k.py:variant=B/4,size=64")
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    raise SystemExit("profile_sampler: needs a CUDA device")

  from small_vision_tpu_torch import convert
  from small_vision_tpu_torch.configs import parse_config
  from small_vision_tpu_torch.tools import export_sampler

  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
  config = parse_config(args.config)
  sample = export_sampler.build_sample_callable(
      config, convert.init_params(config, seed=0), batch_size=args.batch,
      device="cuda")
  sample(1)  # warm-up: kernel builds, cuBLAS handles, allocator
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  sample(2)  # returns numpy: ends in a device-to-host copy
  plain_wall_s = time.perf_counter() - t0

  acts = [torch.profiler.ProfilerActivity.CPU,
          torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=acts) as prof:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sample(2)
    wall_s = time.perf_counter() - t0
  events = kernel_events(prof)
  if not events:
    raise SystemExit("profile_sampler: the trace holds no kernel events")

  by_class = collections.Counter()
  by_name = collections.Counter()
  count = collections.Counter()
  for e in events:
    by_class[classify(e["name"])] += e["dur"]
    by_name[e["name"]] += e["dur"]
    count[classify(e["name"])] += 1
  busy = busy_us((e["ts"], e["ts"] + e["dur"]) for e in events) / 1e6
  kernel_s = sum(by_class.values()) / 1e6
  summary = {
      "card": card, "batch": args.batch, "wall_s": plain_wall_s,
      "img_per_s": args.batch / plain_wall_s, "profiled_wall_s": wall_s,
      "kernels": len(events), "device_busy_s": busy,
      "device_busy_share": busy / plain_wall_s,
      "classes": {c: {"s": by_class[c] / 1e6, "launches": count[c],
                      "share_of_kernel_time": by_class[c] / 1e6 / kernel_s}
                  for c in sorted(by_class)},
      "top": [{"name": n[:120], "s": t / 1e6}
              for n, t in by_name.most_common(10)],
  }
  print(f"[profile] {card}: one sampler call at batch {args.batch}: "
        f"{plain_wall_s:.3f} s wall ({args.batch / plain_wall_s:.2f} img/s; "
        f"{wall_s:.3f} s under the profiler), {len(events)} kernels, device "
        f"busy {busy:.3f} s ({busy / plain_wall_s:.1%} of the unprofiled "
        f"call)", flush=True)
  for c, v in summary["classes"].items():
    print(f"[profile]   {c:22s} {v['s']:.4f} s in {v['launches']} launches "
          f"({v['share_of_kernel_time']:.1%} of kernel time)", flush=True)
  print(json.dumps(summary), flush=True)


if __name__ == "__main__":
  main()
