"""Where the time of one sampler call goes on the GPU.

  python -m small_vision_tpu_torch.tools.profile_sampler [--batch 64]
      [--config ae_i1k.py:attn_impl=pallas_fused]

Builds the UMD-B/4@64 `uncond_eps` sampler from weights drawn with seed 0
(as chip_smoke.py does), makes one warm-up call, then traces one call with
torch.profiler and prints, with the card's name and power limit:
  - the wall time and img/s of one call without the profiler;
  - the device-busy time of the traced call (the union of kernel
    intervals), and its share of the untraced call's wall time;
  - device time by class (`classify`): the port's forward kernels (K1, K3,
    or K1, K5, K6 under attn_impl=pallas_fused; bf16, f32 and wide
    instances alike), matmuls, the rest;
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

# Device-time classes by kernel name, as the trace gives it (demangled) or
# mangled: the port's kernels by their K number, their bf16, f32 and wide
# instances alike, then cuBLAS's matmuls; the rest is "other". K3's and K7's
# f32 forward is one kernel under two softmax policies, and so are K4's and
# K8's f32 backwards (and K4's and K8's wide bf16 ones, under a bool): the
# policy tells them apart. K5's and K6's f32 launches of the one SIMT GEMM
# carry their caller's tag (`FusedMlp`, `FusedMha`).
CLASSES = (
    ("K1 ln_modulate_fwd", re.compile(r"ln_modulate_fwd(_any)?_kernel")),
    ("K2 ln_modulate_bwd", re.compile(r"ln_modulate_bwd(_any)?_kernel")),
    ("K3 attention_packed_fwd", re.compile(
        r"attention_packed_(fwd|wide)_kernel"
        r"|attn_f32x3_fwd_kernel.{0,16}ClampExp2")),
    ("K4 attention_packed_bwd", re.compile(
        r"attn_bwd_(dq|dkdv)|attn_bwd_wide_(rows|dq|dkdv)(<false>|ILb0E)"
        r"|attn_f32x3_(stats|dq|dkdv)_kernel.{0,16}ClampExp2")),
    ("K5 fused_mlp_fwd", re.compile(
        r"fused_mlp_(up|down)_kernel|gemm_f32_kernel.{0,40}FusedMlp")),
    ("K6 fused_mha_fwd", re.compile(
        r"fused_mha_(proj|attn|attn_wide)_kernel|attn_f32_fwd_kernel"
        r"|gemm_f32_kernel.{0,40}FusedMha")),
    ("K7 attention_unpacked_fwd", re.compile(
        r"attention_unpacked_(fwd|wide)_kernel"
        r"|attn_f32x3_fwd_kernel.{0,16}MaxShift")),
    ("K8 attention_unpacked_bwd", re.compile(
        r"attn_unpacked_bwd_(dq|dkdv)_sm90"
        r"|attn_bwd_wide_(rows|dq|dkdv)(<true>|ILb1E)"
        r"|attn_f32x3_(stats|dq|dkdv)_kernel.{0,16}MaxShift")),
    ("K9 attention_ablate", re.compile(r"attention_ablate(_wide)?_kernel")),
    ("matmul", re.compile(r"gemm|xmma|cutlass|nvjet|cublas", re.I)),
)


def classify(name: str) -> str:
  """The class of the kernel `name`."""
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


def trace_events(prof) -> list:
  """Every event of the profiler's Chrome-trace export."""
  fd, path = tempfile.mkstemp(suffix=".json")
  os.close(fd)
  try:
    prof.export_chrome_trace(path)
    with open(path) as f:
      trace = json.load(f)
  finally:
    os.remove(path)
  return trace.get("traceEvents", [])


def kernel_events(prof, events=None):
  return [e for e in (trace_events(prof) if events is None else events)
          if e.get("cat") == "kernel" and "dur" in e]


def card_line() -> str:
  """The card's name and power limit, as nvidia-smi gives them."""
  return subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


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

  card = card_line()
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
    cls = classify(e["name"])
    by_class[cls] += e["dur"]
    by_name[e["name"]] += e["dur"]
    count[cls] += 1
  busy = busy_us((e["ts"], e["ts"] + e["dur"]) for e in events) / 1e6
  kernel_s = sum(by_class.values()) / 1e6
  summary = {
      "card": card, "config": args.config, "batch": args.batch,
      "wall_s": plain_wall_s,
      "img_per_s": args.batch / plain_wall_s, "profiled_wall_s": wall_s,
      "kernels": len(events), "device_busy_s": busy,
      "device_busy_share": busy / plain_wall_s,
      "classes": {c: {"s": by_class[c] / 1e6, "launches": count[c],
                      "share_of_kernel_time": by_class[c] / 1e6 / kernel_s}
                  for c in sorted(by_class)},
      "top": [{"name": n[:120], "s": t / 1e6}
              for n, t in by_name.most_common(10)],
  }
  print(f"[profile] {card}: {args.config}: one sampler call at batch "
        f"{args.batch}: "
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
