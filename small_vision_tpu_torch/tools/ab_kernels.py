"""Holds this tree's max-shift attention kernels (K6, K7, K8, K9) and the
LayerNorm-modulate backward (K2) against another tree's, on the card, and
K1-K4 at a width and head count of the variant tables.

  python -m small_vision_tpu_torch.tools.ab_kernels --other DIR
      [--rounds 3] [--iters 50] [--out FILE] [--width 768 --heads 12]

K6's attention stage, K7 and the seven arms of K9 run one shared core
(`csrc/sm90_attention.cuh`), so a change there moves all three. This tool
builds `fused_mha.cu`, `attention_unpacked.cu`, `attention_ablate.cu`,
`attention_unpacked_bwd.cu` and `ln_modulate_bwd.cu` of DIR (the
`small_vision_tpu_torch/csrc` directory of another checkout, e.g. the
parent commit unpacked with `git archive`) into a temporary directory and
loads them beside this tree's libraries. Then, on inputs from a
`torch.Generator` seeded 0:
  A tree whose K6-K9 take head dim 64 only (no `*_max_head_dim` entry
  point) is bound to its signatures of then; every shape here is at head
  dim 64.
  - K6 (the whole fused MHA forward) at the sampler's shape (B=64, L=260)
    and at (128, 257), 768 wide, 12 heads of 64: both sides must give the
    same bits (`torch.equal`); the call and its attention launch alone are
    timed. No fused MLP runs in this tool, so K6 is read away from the
    power draw of K5.
  - K7 on [B, L, 12, 64] at (64, 260) and (128, 257), and K9's seven arms
    on (B, L, 768) at (128, 257) and (128, 164), each beside
    `scaled_dot_product_attention` on the same inputs.
  - K8 on [128, L, 12, 64] and K2 on (128, L, 768) with modulation, at the
    training lengths L = 68, 164, 257, beside SDPA's backward and the
    autograd backward of `F.layer_norm` and the modulation. Their bits may
    differ between the trees (their sums and exps may be regrouped), so
    only their times are held.
  - K1, K2, K3 and K4 at `--width` and `--heads` (head dim width / heads)
    at the training lengths L = 68, 164, 257 and batch 128, modulated,
    beside `F.layer_norm` + modulate, its autograd backward, SDPA and its
    backward.
Each time is the mean of `--iters` launches between two CUDA events after
a warm-up launch, taken in turns (other, this, this, other) for `--rounds`
rounds; the tool prints the median and the range of each, beside the
card's name and power limit, and writes them as JSON to `--out`.
"""

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import tempfile

import numpy as np
import torch

from small_vision_tpu_torch.ops import _build
from small_vision_tpu_torch.ops import attention as attn
from small_vision_tpu_torch.ops import fused_block as fb
from small_vision_tpu_torch.tools.profile_sampler import card_line

WIDTH, HEADS = 768, 12
K6_SHAPES = ((64, 260), (128, 257))
K7_SHAPES = ((64, 260), (128, 257))
K9_SHAPES = ((128, 257), (128, 164))
TRAIN_SHAPES = ((128, 68), (128, 164), (128, 257))  # K8 and K2
SOURCES = ("fused_mha", "attention_unpacked", "attention_ablate",
           "attention_unpacked_bwd", "ln_modulate_bwd", "ln_modulate",
           "attention_packed", "attention_packed_bwd")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def dev_ms(fn, iters) -> float:
  """Mean ms of one call of `fn` over `iters` calls, by CUDA events, after
  one warm-up call."""
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / iters


def build_other(csrc: pathlib.Path, out_dir: pathlib.Path) -> dict:
  """{source stem: its library built from `csrc`}, one nvcc each, all at
  once, with this tree's flags, and bound by this tree's signatures."""
  procs = {}
  for stem in SOURCES:
    out = out_dir / f"{stem}_other.so"
    procs[stem] = (out, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(out),
         str(csrc / f"{stem}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
  libs = {}
  for stem, (out, proc) in procs.items():
    log, _ = proc.communicate()
    if proc.returncode != 0:
      raise SystemExit(f"ab_kernels: nvcc failed on {stem}.cu:\n{log}")
    libs[stem] = _build.bind(ctypes.CDLL(str(out)), stem)
  return libs


def _check(status):
  _build.check(status, "ab_kernels")


# The argument types of K6-K9's entry points before they took the head dim.
_NO_HEAD_DIM = {
    "fused_mha_fwd": [_P] * 12 + [_I, _I, _I, _I, _F, _P],
    "fused_mha_attention": [_P, _P, _I, _I, _I, _F, _P],
    "attention_unpacked_fwd": [_P] * 4 + [_I, _I, _I, _F, _P],
    "attention_unpacked_bwd": [_P] * 10 + [_I, _I, _I, _F, _P],
    "attention_ablate_fwd": [_P] * 4 + [_I, _I, _I, _F, _I, _P],
}


def _head_dim_args(lib, marker: str) -> tuple:
  """(64,), the head dim argument, for a library whose entry points take
  it (it has the entry point `marker`); for an older one, () once its
  entry points are bound to their signatures of then."""
  if hasattr(lib, marker):
    return (64,)
  for entry, args in _NO_HEAD_DIM.items():
    if hasattr(lib, entry):
      getattr(lib, entry).argtypes = args
  return ()


def k6_launches(lib, x, params, b, l):
  """{"call", "attention": a function that launches it} and the call's
  output, on buffers made here."""
  qkv = torch.empty(b, l, 3 * WIDTH, dtype=x.dtype, device=x.device)
  heads, o = torch.empty_like(x), torch.empty_like(x)
  stream = torch.cuda.current_stream().cuda_stream
  scale = attn.scale_f32(64)
  ptrs = [t.data_ptr() for t in (x, *params, qkv, heads, o)]
  hd = _head_dim_args(lib, "fused_mha_max_head_dim")
  shape = (b, l, WIDTH, HEADS, *hd)
  return {
      "call": lambda: _check(lib.fused_mha_fwd(*ptrs, *shape, scale,
                                               stream)),
      "attention": lambda: _check(lib.fused_mha_attention(
          qkv.data_ptr(), heads.data_ptr(), b, l, HEADS, *hd, scale,
          stream)),
  }, o


def k1_to_k4(sides, width, heads, b, l, randn, keep, pairs, library):
  """K1-K4 of each side and their library calls, at (b, l, width) with
  `heads` heads, into `pairs` and `library`."""
  hd = width // heads
  stream = lambda: torch.cuda.current_stream().cuda_stream
  x, dy = randn(b, l, width), randn(b, l, width)
  q, k, v, do = (randn(b, l, width) for _ in range(4))
  gamma = 1.0 + 0.1 * randn(width).float()
  beta = 0.1 * randn(width).float()
  shift, mod = randn(b, 2 * width).chunk(2, dim=-1)
  xf = x.float()
  mean = xf.mean(-1)
  rstd = torch.rsqrt((xf - mean[..., None]).square().mean(-1) + 1e-6)
  keep += [x, dy, q, k, v, do, gamma, beta, shift, mod, mean, rstd]
  tag = f"{b}x{l} D={width} H={heads}"
  for side, libs in sides.items():
    y = torch.empty_like(x)
    o3 = [torch.empty_like(q) for _ in range(3)]
    rc = [torch.empty(b, heads, l, device="cuda") for _ in range(2)]
    keep += [y, *o3, *rc]
    k1 = [t.data_ptr() for t in (x, gamma, beta, shift, mod)]
    pairs.setdefault(f"K1 {tag}", {})[side] = (
        lambda lib=libs["ln_modulate"], p=k1, y=y: _check(
            lib.ln_modulate_fwd(*p, mod.stride(0), y.data_ptr(), None, None,
                                b * l, l, width, 1e-6, stream())))
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    pairs.setdefault(f"K3 {tag}", {})[side] = (
        lambda lib=libs["attention_packed"], o=o3[0]: _check(
            lib.attention_packed_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                b, l, heads, hd, attn.scale_log2(hd), stream())))
    pairs.setdefault(f"K4 {tag}", {})[side] = (
        lambda lib=libs["attention_packed_bwd"], o3=o3, rc=rc:
        _check(lib.attention_packed_bwd(
            *[t.data_ptr() for t in (q, k, v, do, *o3, *rc)], b, l, heads,
            hd, attn.scale_log2(hd), scale, stream())))
  g16, b16 = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)
  library[f"K1 {tag}"] = (
      lambda: torch.nn.functional.layer_norm(x, (width,), g16, b16, 1e-6)
      * (1 + mod[:, None]) + shift[:, None])
  split = [t.view(b, l, heads, hd).transpose(1, 2).detach().requires_grad_()
           for t in (q, k, v)]
  library[f"K3 {tag}"] = (
      lambda: torch.nn.functional.scaled_dot_product_attention(*split))
  o = torch.nn.functional.scaled_dot_product_attention(*split)
  library[f"K4 {tag}"] = (
      lambda g=do.view(b, l, heads, hd).transpose(1, 2):
      torch.autograd.grad(o, split, g, retain_graph=True))


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument("--other", required=True,
                      help="another checkout's small_vision_tpu_torch/csrc")
  parser.add_argument("--rounds", type=int, default=3)
  parser.add_argument("--iters", type=int, default=50)
  parser.add_argument("--out", default=None, help="JSON file of the times")
  parser.add_argument("--width", type=int, default=WIDTH,
                      help="K1-K4's width (a multiple of 32 up to 2,048)")
  parser.add_argument("--heads", type=int, default=HEADS,
                      help="K3/K4's heads; width / heads a multiple of 8 "
                      "up to 128")
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    raise SystemExit("ab_kernels: needs a CUDA device")
  card = card_line()
  gen = torch.Generator(device="cuda").manual_seed(0)
  randn = lambda *s, std=1.0: (torch.randn(*s, generator=gen, device="cuda")
                               * std).to(torch.bfloat16)
  stream = lambda: torch.cuda.current_stream().cuda_stream
  scale = float(np.float32(1.0 / np.sqrt(64)))
  this = {stem: _build.library(stem) for stem in SOURCES}
  # name: {"other": fn, "this": fn} to time; name: the library call's fn.
  # The functions hold raw pointers: `keep` holds their tensors.
  pairs, library, same_bits, keep = {}, {}, {}, []

  params = []
  for _ in range(4):
    params += [randn(WIDTH, WIDTH, std=WIDTH**-0.5), randn(WIDTH, std=0.1)]
  with tempfile.TemporaryDirectory() as tmp:
    other = build_other(pathlib.Path(args.other), pathlib.Path(tmp))
    sides = {"other": other, "this": this}
    head_dims = {s: {stem: _head_dim_args(libs[stem], f"{stem}_max_head_dim")
                     for stem in ("attention_unpacked", "attention_ablate",
                                  "attention_unpacked_bwd")}
                 for s, libs in sides.items()}
    for b, l in K6_SHAPES:
      x = randn(b, l, WIDTH)
      keep.append(x)
      runs, outs = {}, {}
      for side, libs in sides.items():
        runs[side], outs[side] = k6_launches(libs["fused_mha"], x, params,
                                             b, l)
        runs[side]["call"]()
      torch.cuda.synchronize()
      keep += list(outs.values())
      same_bits[f"K6 {b}x{l}"] = torch.equal(outs["other"], outs["this"])
      for stage in ("call", "attention"):
        pairs[f"K6 {stage} {b}x{l}"] = {s: runs[s][stage] for s in sides}

    for b, l in K7_SHAPES:
      q, k, v = (randn(b, l, HEADS, 64) for _ in range(3))
      o = torch.empty_like(q)
      keep += [q, k, v, o]
      ptrs = [t.data_ptr() for t in (q, k, v, o)]
      pairs[f"K7 {b}x{l}"] = {
          s: (lambda lib=libs["attention_unpacked"], p=ptrs, b=b, l=l,
              hd=head_dims[s]["attention_unpacked"]: _check(
                  lib.attention_unpacked_fwd(*p, b, l, HEADS, *hd, scale,
                                             stream())))
          for s, libs in sides.items()}
      heads_first = [t.transpose(1, 2) for t in (q, k, v)]
      library[f"K7 {b}x{l}"] = (
          lambda hf=heads_first:
          torch.nn.functional.scaled_dot_product_attention(*hf))

    for b, l in K9_SHAPES:
      q, k, v = (randn(b, l, WIDTH) for _ in range(3))
      o = torch.empty_like(q)
      keep += [q, k, v, o]
      ptrs = [t.data_ptr() for t in (q, k, v, o)]
      for arm_id, arm in enumerate(attn.ABLATE_VARIANTS):
        pairs[f"K9 {arm} {b}x{l}"] = {
            s: (lambda lib=libs["attention_ablate"], a=arm_id, p=ptrs, b=b,
                l=l, hd=head_dims[s]["attention_ablate"]: _check(
                    lib.attention_ablate_fwd(*p, b, l, HEADS, *hd, scale, a,
                                             stream())))
            for s, libs in sides.items()}
      split = [t.view(b, l, HEADS, 64).transpose(1, 2) for t in (q, k, v)]
      library[f"K9 {b}x{l}"] = (
          lambda sp=split:
          torch.nn.functional.scaled_dot_product_attention(*sp))

    for b, l in TRAIN_SHAPES:
      q, k, v, do = (randn(b, l, HEADS, 64) for _ in range(4))
      outs = [torch.empty_like(q) for _ in range(3)] + [
          torch.empty(b, HEADS, l, device="cuda") for _ in range(3)]
      keep += [q, k, v, do, *outs]
      ptrs = [t.data_ptr() for t in (q, k, v, do, *outs)]
      pairs[f"K8 {b}x{l}"] = {
          s: (lambda lib=libs["attention_unpacked_bwd"], p=ptrs, b=b, l=l,
              hd=head_dims[s]["attention_unpacked_bwd"]:
              _check(lib.attention_unpacked_bwd(*p, b, l, HEADS, *hd, scale,
                                                stream())))
          for s, libs in sides.items()}
      heads_first = [t.transpose(1, 2).detach().requires_grad_()
                     for t in (q, k, v)]
      o = torch.nn.functional.scaled_dot_product_attention(*heads_first)
      library[f"K8 {b}x{l}"] = (
          lambda o=o, hf=heads_first, g=do.transpose(1, 2):
          torch.autograd.grad(o, hf, g, retain_graph=True))

      x, dy = randn(b, l, WIDTH), randn(b, l, WIDTH)
      xf = x.float()
      mean = xf.mean(-1)
      rstd = torch.rsqrt((xf - mean[..., None]).square().mean(-1) + 1e-6)
      gamma = 1.0 + 0.1 * randn(WIDTH).float()
      beta = 0.1 * randn(WIDTH).float()
      shift, mod = randn(b, 2 * WIDTH).chunk(2, dim=-1)
      for side, libs in sides.items():
        lib = libs["ln_modulate_bwd"]
        outs = [torch.empty_like(x)] + [
            torch.empty(*shape, device="cuda")
            for shape in ((WIDTH,), (WIDTH,), (b, WIDTH), (b, WIDTH),
                          (lib.ln_modulate_bwd_work_words(b, l, WIDTH),))]
        keep += outs
        ptrs = [t.data_ptr() for t in (x, dy, mean, rstd, gamma, beta, mod)]
        pairs.setdefault(f"K2 {b}x{l}", {})[side] = (
            lambda lib=lib, p=ptrs + [mod.stride(0)] + [
                t.data_ptr() for t in outs], b=b, l=l:
            _check(lib.ln_modulate_bwd(*p, b, l, WIDTH, stream())))
      keep += [x, dy, mean, rstd, gamma, beta, shift, mod]
      xg = x.clone().requires_grad_()
      g16, b16 = (t.to(torch.bfloat16).requires_grad_() for t in (gamma, beta))
      sh, sc = (t.clone().requires_grad_() for t in (shift, mod))
      y = (torch.nn.functional.layer_norm(xg, (WIDTH,), g16, b16, 1e-6)
           * (1 + sc[:, None]) + sh[:, None])
      library[f"K2 {b}x{l}"] = (
          lambda y=y, leaves=(xg, g16, b16, sh, sc), dy=dy:
          torch.autograd.grad(y, leaves, dy, retain_graph=True))

    for b, l in TRAIN_SHAPES:
      k1_to_k4(sides, args.width, args.heads, b, l, randn, keep, pairs,
               library)

    times = {name: {side: [] for side in fns} for name, fns in pairs.items()}
    lib_times = {name: [] for name in library}
    for _ in range(args.rounds):
      for name, fns in pairs.items():
        for side in ("other", "this", "this", "other"):
          times[name][side].append(dev_ms(fns[side], args.iters))
      for name, fn in library.items():
        lib_times[name].append(dev_ms(fn, args.iters))

  summary = lambda v: dict(median=statistics.median(v), min=min(v),
                           max=max(v))
  result = {"card": card, "same_bits": same_bits,
            "times": {name: {side: summary(v) for side, v in t.items()}
                      for name, t in times.items()},
            "library": {name: summary(v) for name, v in lib_times.items()}}
  print(f"[ab_kernels] K6 bit-equal to the other build: {same_bits}; on "
        f"{card}", flush=True)
  for name, t in result["times"].items():
    print(f"[ab_kernels] {name}: this {t['this']['median']:.4f} ms "
          f"({t['this']['min']:.4f}-{t['this']['max']:.4f}), other "
          f"{t['other']['median']:.4f} ({t['other']['min']:.4f}"
          f"-{t['other']['max']:.4f}), this/other "
          f"{t['this']['median'] / t['other']['median']:.3f}", flush=True)
  for name, t in result["library"].items():
    print(f"[ab_kernels] {name} library: {t['median']:.4f} ms "
          f"({t['min']:.4f}-{t['max']:.4f})", flush=True)
  if args.out:
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
  if not all(same_bits.values()):
    raise SystemExit("ab_kernels: K6 gives other bits than the other "
                     "build")
  return result


if __name__ == "__main__":
  main()
