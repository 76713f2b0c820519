"""Reads the timed end-to-end windows of `chip_smoke.py`'s phases train,
serve and settings for this checkout and another, on one card, in turns.

  python -m small_vision_tpu_torch.tools.ab_smoke --other DIR
      [--rounds 1] [--phases train,settings,serve] [--out FILE]

DIR is the root of another checkout (e.g. the parent commit unpacked with
`git archive`). Each run is a process of its own, started in its
checkout's root: it imports that checkout's `chip_smoke.py`, builds that
checkout's kernels (into its own `small_vision_tpu_torch/_build/`) and
drives, as the smoke does, `phase_train` under "pallas" and
"pallas_fused" with requalified windows, `phase_settings` ((a)
heads=6,scan=True and (c) UMD-S/4 windowed, (b) one heads=6 sampler call,
(d) runlocal through cli.py, (e) UMD-L/2@256 under scan=True),
`phase_serve` (the server's sampler, windowed) and `phase_sample_call`
under "pallas_fused", windowed; `--phases` takes a subset. Every check of
those phases holds, so a run fails where the smoke would. The runs go
other, this, this, other for
`--rounds` rounds; the tool prints every reading of every run and their
medians beside the card's name and power limit, and writes them as JSON
to `--out`.
"""

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile

import torch

from small_vision_tpu_torch.tools.profile_sampler import card_line

ROOT = pathlib.Path(__file__).resolve().parents[2]

PHASES = ("train", "settings", "serve")

# One run, in a checkout's root; argv[1] is the JSON file it writes, argv[2]
# the phases, comma-separated.
RUNNER = r"""
import json, sys
import torch
import chip_smoke as cs
from small_vision_tpu_torch.ops import _build as build

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
phases = sys.argv[2].split(",")
card = cs.card_line()
cs.phase_build(build)
q = lambda got: {k: got["qual"][k] for k in
                 ("median", "windows", "spread_pct", "host_contended")}
out = {}
if "train" in phases:
  for a in cs.ATTN_IMPLS:
    out[f"train {a} img/s"] = q(cs.phase_train(build, card, a, windows=True))
if "settings" in phases:
  settings = cs.phase_settings(build, card)
  out.update({
      "settings (a) heads=6,scan=True img/s": q(settings["a"]),
      "settings (b) sampler heads=6 img/s": {
          "median": settings["b"]["img_per_s"]},
      "settings (c) UMD-S/4 img/s": q(settings["c"]),
      "settings (d) runlocal s": {"median": settings["d"]["s"]},
      "settings (e) UMD-L/2 scan=True img/s": {
          "median": settings["e"]["img_per_s"]}})
if "serve" in phases:
  out["serve pallas img/s"] = q(cs.phase_serve(build, card))
  out["serve pallas_fused img/s"] = q(cs.phase_sample_call(
      build, card, "pallas_fused", windows=True))
with open(sys.argv[1], "w") as f:
  json.dump(out, f)
"""


def run_one(root: pathlib.Path, tmp: pathlib.Path, tag: str, phases: str,
            timeout: int) -> dict:
  """The readings of one run of `phases` in the checkout at `root`; its
  log goes to `tmp/<tag>.log`, whose tail is raised with a failure."""
  result, log = tmp / f"{tag}.json", tmp / f"{tag}.log"
  with open(log, "w") as f:
    proc = subprocess.run([sys.executable, "-c", RUNNER, str(result),
                           phases], cwd=root, stdout=f,
                          stderr=subprocess.STDOUT, timeout=timeout)
  if proc.returncode != 0:
    tail = log.read_text().splitlines()[-30:]
    raise SystemExit(f"ab_smoke: run {tag} in {root} failed "
                     f"(rc {proc.returncode}):\n" + "\n".join(tail))
  return json.loads(result.read_text())


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument("--other", required=True,
                      help="the root of another checkout")
  parser.add_argument("--rounds", type=int, default=1)
  parser.add_argument("--phases", default=",".join(PHASES),
                      help="a comma-separated subset of " + ", ".join(PHASES))
  parser.add_argument("--timeout", type=int, default=900,
                      help="seconds a run may take")
  parser.add_argument("--out", default=None, help="JSON file of the readings")
  args = parser.parse_args(argv)
  if not args.phases or not set(args.phases.split(",")) <= set(PHASES):
    raise SystemExit(f"ab_smoke: --phases {args.phases!r} is not a subset "
                     f"of {', '.join(PHASES)}")
  if not torch.cuda.is_available():
    raise SystemExit("ab_smoke: needs a CUDA device")
  card = card_line()
  sides = {"other": pathlib.Path(args.other).resolve(), "this": ROOT}
  runs = {"other": [], "this": []}
  with tempfile.TemporaryDirectory() as tmp:
    for r in range(args.rounds):
      for i, side in enumerate(("other", "this", "this", "other")):
        got = run_one(sides[side], pathlib.Path(tmp), f"{r}_{i}_{side}",
                      args.phases, args.timeout)
        runs[side].append(got)
        print(f"[ab_smoke] round {r} run {i} ({side}): " + "; ".join(
            f"{name} {v['median']:.2f}" for name, v in got.items()),
              flush=True)
  result = {"card": card, "runs": runs, "median": {}}
  for name in runs["this"][0]:
    med = {side: statistics.median(g[name]["median"] for g in got)
           for side, got in runs.items()}
    result["median"][name] = med
    print(f"[ab_smoke] {name}: this " + ", ".join(
        f"{g[name]['median']:.2f}" for g in runs["this"]) + " (median "
          f"{med['this']:.2f}), other " + ", ".join(
              f"{g[name]['median']:.2f}" for g in runs["other"])
          + f" (median {med['other']:.2f}), this/other "
          f"{med['this'] / med['other']:.3f}; on {card}", flush=True)
  if args.out:
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
  return result


if __name__ == "__main__":
  main()
