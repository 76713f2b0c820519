"""Holds this tree's attention kernels (K3, K4, K6, K7, K8, K9), the fused
MLP (K5) and the LayerNorm-modulate backward (K2) against another tree's,
on the card, K1-K4
at a width and head count of the variant tables, and times K3, K6, K7 and
K9 of this tree alone at the long shapes that the other may refuse, and
every attention kernel of this tree alone at head dims 192 and 256.

  python -m small_vision_tpu_torch.tools.ab_kernels --other DIR
      [--rounds 3] [--iters 50] [--out FILE] [--width 768 --heads 12]

K6's attention stage, K7 and the seven arms of K9 run one shared core
(`csrc/sm90_attention.cuh`), so a change there moves all three. This tool
builds the kernels of DIR (the `small_vision_tpu_torch/csrc` directory of
another checkout, e.g. the parent commit unpacked with `git archive`) into
a temporary directory with this tree's flags, binds them by this tree's
signatures (the other tree's entry points must take the same arguments)
and loads them beside this tree's libraries. Then, on inputs from a
`torch.Generator` seeded 0:
  - K3 on (B, L, 768) at the sampler's (64, 260) and the training shapes
    (128, L = 68, 164, 257), K7 on [B, L, 12, 64] at (64, 260) and (128,
    257), both also at (64, 576) (ViT-B/16@384's length), K9's seven arms
    on (B, L, 768) at (128, 257) and (128, 164), and K6 (the whole fused
    MHA forward, 768 wide, 12 heads of 64) at (64, 260) and (128, 257):
    both trees must give the same bits (`torch.equal`); each is timed
    beside `scaled_dot_product_attention` on the same inputs (K6: the call
    and its attention launch alone; no fused MLP runs in this tool, so K6
    is read away from the power draw of K5).
  - K5 (the fused MLP's two kernels, `fused_mlp_fwd`) on (B, L, 768) with
    hidden 3,072 at (64, 260) and (128, 257), and on (64, 257, 1,024)
    with hidden 4,096: both trees must give the same bits; each is timed
    beside F.linear, tanh-gelu, F.linear on the same inputs.
  - K3 and K7 of this tree with K and V resident against streamed through
    the ring (their `*_fwd_streamed` entry points) at (64, 260) and (128,
    257): the cost of streaming where the heads are short.
  - K8 on [128, L, 12, 64] and K2 on (128, L, 768) with modulation, at the
    training lengths L = 68, 164, 257, beside SDPA's backward and the
    autograd backward of `F.layer_norm` and the modulation. K8's dq, dk
    and dv must be the other tree's bits, and so must K2's five outputs.
  - K1, K2, K3 and K4 at `--width` and `--heads` (head dim width / heads)
    at the training lengths L = 68, 164, 257 and batch 128, modulated,
    beside `F.layer_norm` + modulate, its autograd backward, SDPA and its
    backward; K1's, K3's and K4's outputs must be the other tree's bits.
  - The f32 instances of K3, K4, K7 and K8 (`attention_packed_f32.cu`,
    `attention_unpacked_f32.cu`) on (B, L, 768) f32 in 12 heads of 64 at
    the sampler's (64, 260) and the training shapes (128, L = 68, 164,
    257), and K6's (`fused_mha_f32.cu`) at (64, 260) and (128, 257): K4's,
    K8's and K6's outputs must be the other tree's bits; K3's and K7's
    (3xTF32 forwards in this tree) within 1e-4 of the other's output, and
    this tree's the same bits launch to launch. Each is timed in turns.
  - This tree alone: K3, K7, K6 (call and attention launch) and K9's seven
    arms at (64, 1,024) and (64, 1,025) with 16 heads of 64 (ViT-L/16@512,
    "map" and "tok"), (64, 1,369) with 16 heads of 80 (ViT-H/14@518) and
    (4, 4,096) with 12 heads of 64, each beside SDPA and its bound: the
    larger of q, k, v and o's bytes over 3.35 TB/s and 4 B H L^2 D
    operations over 989 TFLOP/s.
  - This tree alone at the head dims that take three and four 64-column
    tiles a head (`WIDE_HEADS`: 4 heads of 192 and 3 of 256 at width
    768): K3 at the sampler's (64, 260) and the training shapes (128, L =
    68, 164, 257), K4 and K8 at the training shapes, K6 (call and
    attention launch) and K7 at (64, 260) and (128, 257), K9's seven arms
    at (128, 257) and (128, 164), each beside SDPA (or its backward) and
    the bound (a backward's: q, k, v, dO, dq, dk, dv once, or five
    products of 2 B H L^2 D operations).
Each time is the mean of `--iters` launches between two CUDA events after
a warm-up launch; the two sides of a comparison are taken in turns (other,
this, this, other; resident, streamed, streamed, resident) for `--rounds`
rounds. The tool prints the median and the range of each, beside the
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
K3_SHAPES = ((64, 260), (128, 68), (128, 164), (128, 257), (64, 576))
K6_SHAPES = ((64, 260), (128, 257))
K7_SHAPES = ((64, 260), (128, 257), (64, 576))
K9_SHAPES = ((128, 257), (128, 164))
K5_SHAPES = ((64, 260, 768, 3072), (128, 257, 768, 3072),
             (64, 257, 1024, 4096))
STREAM_SHAPES = ((64, 260), (128, 257))  # resident against streamed
# (B, L, heads, head dim) of this tree alone.
LONG_SHAPES = ((64, 1024, 16, 64), (64, 1025, 16, 64), (64, 1369, 16, 80),
               (4, 4096, 12, 64))
TRAIN_SHAPES = ((128, 68), (128, 164), (128, 257))  # K8 and K2
# (heads, head dim) of this tree alone at width 768: `heads=4`, `heads=3`.
WIDE_HEADS = ((4, 192), (3, 256))
SOURCES = ("fused_mlp", "fused_mha", "attention_unpacked",
           "attention_ablate",
           "attention_unpacked_bwd", "ln_modulate_bwd", "ln_modulate",
           "attention_packed", "attention_packed_bwd", "attention_packed_f32",
           "attention_unpacked_f32", "fused_mha_f32")
K3_F32_SHAPES = ((64, 260), (128, 68), (128, 164), (128, 257))


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


def k6_launches(lib, x, params, b, l, width=WIDTH, heads=HEADS):
  """{"call", "attention": a function that launches it} and the call's
  output, on buffers made here; heads of width / heads columns."""
  hd = width // heads
  qkv = torch.empty(b, l, 3 * width, dtype=x.dtype, device=x.device)
  heads_out, o = torch.empty_like(x), torch.empty_like(x)
  stream = torch.cuda.current_stream().cuda_stream
  scale = attn.scale_f32(hd)
  ptrs = [t.data_ptr() for t in (x, *params, qkv, heads_out, o)]
  return {
      "call": lambda: _check(lib.fused_mha_fwd(*ptrs, b, l, width, heads, hd,
                                               scale, stream)),
      "attention": lambda: _check(lib.fused_mha_attention(
          qkv.data_ptr(), heads_out.data_ptr(), b, l, heads, hd, scale,
          stream)),
  }, o


def k5_launch(lib, x, w1, b1, w2, b2):
  """A function that launches K5 (`fused_mlp_fwd`: its up- and
  down-projection kernels) on bf16 x (B, L, d), and its output; the
  hidden activations' scratch is made here and held by the function."""
  b, l, d = x.shape
  hidden = w1.shape[1]
  h = torch.empty(b * l, hidden, dtype=x.dtype, device=x.device)
  y = torch.empty_like(x)
  ptrs = [t.data_ptr() for t in (x, w1, b1, w2, b2, h, y)]
  stream = torch.cuda.current_stream().cuda_stream
  return (lambda h=h: _check(lib.fused_mlp_fwd(*ptrs, b * l, d, hidden,
                                               stream))), y


def attention_launch(lib, entry, q, k, v, heads, *extra):
  """A function that launches `entry` of K3, K7 or K9 (`extra`: K9's arm)
  on packed q, k, v ((B, L, H*D), or [B, L, H, D] for K7), and its
  output."""
  b, l = q.shape[:2]
  hd = q[0, 0].numel() // heads
  o = torch.empty_like(q)
  scale = (attn.scale_log2(hd) if entry.startswith("attention_packed")
           else attn.scale_f32(hd))
  fn = getattr(lib, entry)
  ptrs = [t.data_ptr() for t in (q, k, v, o)]
  stream = torch.cuda.current_stream().cuda_stream
  return (lambda: _check(fn(*ptrs, b, l, heads, hd, scale, *extra,
                            stream))), o


def bound_ms(b, l, heads, hd):
  """The least ms of an attention forward on this card: q, k, v and o
  once over 3.35 TB/s or 4 B H L^2 D operations over 989 TFLOP/s (bf16),
  the larger."""
  return max(4 * b * l * heads * hd * 2 / 3.35e12,
             4 * b * heads * l * l * hd / 989e12) * 1e3


def bwd_bound_ms(b, l, heads, hd):
  """The least ms of an attention backward on this card: q, k, v, dO, dq,
  dk and dv once over 3.35 TB/s or five products of 2 B H L^2 D
  operations over 989 TFLOP/s (bf16), the larger."""
  return max(7 * b * l * heads * hd * 2 / 3.35e12,
             5 * 2 * b * heads * l * l * hd / 989e12) * 1e3


def k1_to_k4(sides, width, heads, b, l, randn, keep, pairs, library,
             outputs):
  """K1-K4 of each side and their library calls, at (b, l, width) with
  `heads` heads, into `pairs` and `library`; K1's, K3's and K4's outputs
  of each side into `outputs` ({name: {side: tensors}})."""
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
    outputs.setdefault(f"K1 {tag}", {})[side] = [y]
    pairs.setdefault(f"K1 {tag}", {})[side] = (
        lambda lib=libs["ln_modulate"], p=k1, y=y: _check(
            lib.ln_modulate_fwd(*p, mod.stride(0), y.data_ptr(), None, None,
                                b * l, l, width, 1e-6, stream())))
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    o_fwd = torch.empty_like(q)
    keep.append(o_fwd)
    pairs.setdefault(f"K3 {tag}", {})[side] = (
        lambda lib=libs["attention_packed"], o=o_fwd: _check(
            lib.attention_packed_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                b, l, heads, hd, attn.scale_log2(hd), stream())))
    pairs.setdefault(f"K4 {tag}", {})[side] = (
        lambda lib=libs["attention_packed_bwd"], o3=o3, rc=rc:
        _check(lib.attention_packed_bwd(
            *[t.data_ptr() for t in (q, k, v, do, *o3, *rc)], b, l, heads,
            hd, attn.scale_log2(hd), scale, stream())))
    outputs.setdefault(f"K3 {tag}", {})[side] = [o_fwd]
    outputs.setdefault(f"K4 {tag}", {})[side] = o3
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


def f32_attention(sides, b, l, randn32, keep, pairs, outputs, changed):
  """The f32 instances of each side at (b, l, 768) in 12 heads of 64 into
  `pairs`: K4 and K8, whose outputs of each side go into `outputs` (the
  same bits expected), and K3 and K7, whose forwards this tree runs 3xTF32
  on the tensor cores (other arithmetic: their outputs of each side go
  into `changed`, held to 1e-4 of each other and to the same bits launch
  to launch)."""
  stream = lambda: torch.cuda.current_stream().cuda_stream
  hd = WIDTH // HEADS
  q, k, v, do = (randn32(b, l, WIDTH) for _ in range(4))
  keep += [q, k, v, do]
  scales = (b, l, HEADS, hd, attn.scale_log2(hd))
  for side, libs in sides.items():
    packed, unpacked = (libs["attention_packed_f32"],
                        libs["attention_unpacked_f32"])
    o3, o7 = torch.empty_like(q), torch.empty_like(q)
    g4, g8 = ([torch.empty_like(q) for _ in range(3)] for _ in range(2))
    s4, s8 = ([torch.empty(b, HEADS, l, device="cuda") for _ in range(n)]
              for n in (2, 3))
    keep += [o3, o7, *g4, *g8, *s4, *s8]
    fwd = lambda lib, entry, o: (lambda: _check(getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *scales,
        stream())))
    pairs.setdefault(f"K3 f32 {b}x{l}", {})[side] = fwd(
        packed, "attention_packed_f32_fwd", o3)
    pairs.setdefault(f"K7 f32 {b}x{l}", {})[side] = fwd(
        unpacked, "attention_unpacked_f32_fwd", o7)
    pairs.setdefault(f"K4 f32 {b}x{l}", {})[side] = (
        lambda lib=packed, g=g4, st=s4: _check(lib.attention_packed_f32_bwd(
            *[t.data_ptr() for t in (q, k, v, do, *g, *st)], *scales,
            attn.scale_f32(hd), stream())))
    pairs.setdefault(f"K8 f32 {b}x{l}", {})[side] = (
        lambda lib=unpacked, g=g8, st=s8: _check(
            lib.attention_unpacked_f32_bwd(
                *[t.data_ptr() for t in (q, k, v, do, *g, *st)], *scales,
                attn.scale_f32(hd), stream())))
    changed.setdefault(f"K3 f32 {b}x{l}", {})[side] = [o3]
    changed.setdefault(f"K7 f32 {b}x{l}", {})[side] = [o7]
    outputs.setdefault(f"K4 f32 {b}x{l}", {})[side] = g4
    outputs.setdefault(f"K8 f32 {b}x{l}", {})[side] = g8


def k6_f32(sides, b, l, randn32, keep, pairs, outputs):
  """K6's f32 instance of each side (the whole fused MHA forward, 768
  wide, 12 heads of 64) at (b, l) into `pairs`, its output into
  `outputs`."""
  stream = lambda: torch.cuda.current_stream().cuda_stream
  x = randn32(b, l, WIDTH)
  params = []
  for _ in range(4):
    params += [randn32(WIDTH, WIDTH) * WIDTH**-0.5, randn32(WIDTH) * 0.1]
  keep += [x, *params]
  for side, libs in sides.items():
    qkv = torch.empty(b, l, 3 * WIDTH, device="cuda")
    heads_out, o = torch.empty_like(x), torch.empty_like(x)
    keep += [qkv, heads_out, o]
    ptrs = [t.data_ptr() for t in (x, *params, qkv, heads_out, o)]
    pairs.setdefault(f"K6 f32 call {b}x{l}", {})[side] = (
        lambda lib=libs["fused_mha_f32"], p=ptrs: _check(lib.fused_mha_f32_fwd(
            *p, b, l, WIDTH, HEADS, WIDTH // HEADS,
            attn.scale_log2(WIDTH // HEADS), stream())))
    outputs.setdefault(f"K6 f32 call {b}x{l}", {})[side] = [o]


def wide_heads(this, heads, hd, randn, keep, alone, bounds, library):
  """This tree's K3, K4, K6, K7, K8 and K9 at `heads` heads of `hd` (width
  heads * hd) at their shapes of WIDE_HEADS (see the module's docstring)
  into `alone`, with their bounds and library calls."""
  width = heads * hd
  sdpa = torch.nn.functional.scaled_dot_product_attention
  stream = lambda: torch.cuda.current_stream().cuda_stream
  params = []
  for _ in range(4):
    params += [randn(width, width, std=width**-0.5), randn(width, std=0.1)]
  keep += params
  for b, l in K3_SHAPES[:4]:
    tag = f"{b}x{l} {heads}x{hd}"
    q, k, v, do = (randn(b, l, width) for _ in range(4))
    q4, k4, v4, do4 = (t.view(b, l, heads, hd) for t in (q, k, v, do))
    keep += [q, k, v, do]
    hf = [t.transpose(1, 2).detach().requires_grad_() for t in (q4, k4, v4)]
    o = sdpa(*hf)
    library[f"forward {tag}"] = (
        lambda hf=[t.detach() for t in hf]: sdpa(*hf))
    fns = {"K3": attention_launch(this["attention_packed"],
                                  "attention_packed_fwd", q, k, v, heads)}
    if (b, l) in K6_SHAPES:
      x = randn(b, l, width)
      keep.append(x)
      k6, o6 = k6_launches(this["fused_mha"], x, params, b, l, width, heads)
      fns["K6 call"] = (k6["call"], o6)
      fns["K6 attention"] = (k6["attention"], o6)
      fns["K7"] = attention_launch(this["attention_unpacked"],
                                   "attention_unpacked_fwd", q4, k4, v4,
                                   heads)
    if (b, l) in K9_SHAPES:
      for arm_id, arm in enumerate(attn.ABLATE_VARIANTS):
        fns[f"K9 {arm}"] = attention_launch(
            this["attention_ablate"], "attention_ablate_fwd", q, k, v,
            heads, arm_id)
    for name, (fn, out) in fns.items():
      alone[f"{name} {tag}"] = fn
      bounds[f"{name} {tag}"] = bound_ms(b, l, heads, hd)
      keep.append(out)
    if (b, l) not in TRAIN_SHAPES:
      continue
    library[f"backward {tag}"] = (
        lambda o=o, hf=hf, g=do4.transpose(1, 2):
        torch.autograd.grad(o, hf, g, retain_graph=True))
    scale = attn.scale_f32(hd)
    grads = [torch.empty_like(q) for _ in range(3)]
    rc = [torch.empty(b, heads, l, device="cuda") for _ in range(3)]
    keep += grads + rc
    k4_ptrs = [t.data_ptr() for t in (q, k, v, do, *grads, *rc[:2])]
    k8_ptrs = [t.data_ptr() for t in (q4, k4, v4, do4, *grads, *rc)]
    alone[f"K4 {tag}"] = lambda p=k4_ptrs, b=b, l=l: _check(
        this["attention_packed_bwd"].attention_packed_bwd(
            *p, b, l, heads, hd, attn.scale_log2(hd), scale, stream()))
    alone[f"K8 {tag}"] = lambda p=k8_ptrs, b=b, l=l: _check(
        this["attention_unpacked_bwd"].attention_unpacked_bwd(
            *p, b, l, heads, hd, scale, stream()))
    bounds[f"K4 {tag}"] = bounds[f"K8 {tag}"] = bwd_bound_ms(b, l, heads, hd)


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
                      "up to 256")
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    raise SystemExit("ab_kernels: needs a CUDA device")
  card = card_line()
  gen = torch.Generator(device="cuda").manual_seed(0)
  randn = lambda *s, std=1.0: (torch.randn(*s, generator=gen, device="cuda")
                               * std).to(torch.bfloat16)
  stream = lambda: torch.cuda.current_stream().cuda_stream
  scale = float(np.float32(1.0 / np.sqrt(64)))
  sdpa = torch.nn.functional.scaled_dot_product_attention
  this = {stem: _build.library(stem) for stem in SOURCES}
  # name: {side: fn, side: fn} to time in turns; name: the library call's
  # fn; name: this tree's fn alone. The functions hold raw pointers: `keep`
  # holds their tensors.
  pairs, library, alone, bounds, same_bits, keep = {}, {}, {}, {}, {}, []
  # name: {side: its output tensors}, for kernels launched by `pairs`
  # alone (K4, K8): each side launched once, then compared.
  outputs = {}

  def compare(name, runs):
    """runs: {side: (launch fn, output)}; launches each once, records
    whether the outputs are bit-equal, and times the sides in turns."""
    for fn, out in runs.values():
      fn()
      keep.append(out)
    torch.cuda.synchronize()
    first, second = (out for _, out in runs.values())
    same_bits[name] = torch.equal(first, second)
    pairs[name] = {side: fn for side, (fn, _) in runs.items()}

  params = []
  for _ in range(4):
    params += [randn(WIDTH, WIDTH, std=WIDTH**-0.5), randn(WIDTH, std=0.1)]
  with tempfile.TemporaryDirectory() as tmp:
    other = build_other(pathlib.Path(args.other), pathlib.Path(tmp))
    sides = {"other": other, "this": this}
    for b, l in K6_SHAPES:
      x = randn(b, l, WIDTH)
      keep.append(x)
      runs = {side: k6_launches(libs["fused_mha"], x, params, b, l)
              for side, libs in sides.items()}
      compare(f"K6 call {b}x{l}",
              {side: (r["call"], o) for side, (r, o) in runs.items()})
      pairs[f"K6 attention {b}x{l}"] = {
          side: r["attention"] for side, (r, _) in runs.items()}

    lin = torch.nn.functional.linear
    for b, l, d, hidden in K5_SHAPES:
      x = randn(b, l, d)
      w1, b1 = randn(d, hidden, std=d**-0.5), randn(hidden, std=0.1)
      w2, b2 = randn(hidden, d, std=hidden**-0.5), randn(d, std=0.1)
      w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
      keep += [x, w1, b1, w2, b2, w1t, w2t]
      tag = f"K5 {b}x{l}" + ("" if d == WIDTH else f" D{d}")
      compare(tag, {side: k5_launch(libs["fused_mlp"], x, w1, b1, w2, b2)
                    for side, libs in sides.items()})
      library[tag] = (lambda x=x, w1t=w1t, b1=b1, w2t=w2t, b2=b2: lin(
          torch.nn.functional.gelu(lin(x, w1t, b1), approximate="tanh"),
          w2t, b2))

    for b, l in K3_SHAPES:
      q, k, v = (randn(b, l, WIDTH) for _ in range(3))
      keep += [q, k, v]
      compare(f"K3 {b}x{l}", {
          side: attention_launch(libs["attention_packed"],
                                 "attention_packed_fwd", q, k, v, HEADS)
          for side, libs in sides.items()})
      library[f"K3 {b}x{l}"] = (
          lambda sp=[t.view(b, l, HEADS, 64).transpose(1, 2)
                     for t in (q, k, v)]: sdpa(*sp))

    for b, l in K7_SHAPES:
      q, k, v = (randn(b, l, HEADS, 64) for _ in range(3))
      keep += [q, k, v]
      compare(f"K7 {b}x{l}", {
          side: attention_launch(libs["attention_unpacked"],
                                 "attention_unpacked_fwd", q, k, v, HEADS)
          for side, libs in sides.items()})
      library[f"K7 {b}x{l}"] = (
          lambda hf=[t.transpose(1, 2) for t in (q, k, v)]: sdpa(*hf))

    for b, l in K9_SHAPES:
      q, k, v = (randn(b, l, WIDTH) for _ in range(3))
      keep += [q, k, v]
      for arm_id, arm in enumerate(attn.ABLATE_VARIANTS):
        compare(f"K9 {arm} {b}x{l}", {
            side: attention_launch(libs["attention_ablate"],
                                   "attention_ablate_fwd", q, k, v, HEADS,
                                   arm_id)
            for side, libs in sides.items()})
      library[f"K9 {b}x{l}"] = (
          lambda sp=[t.view(b, l, HEADS, 64).transpose(1, 2)
                     for t in (q, k, v)]: sdpa(*sp))

    # This tree's K3 and K7 with K and V resident, then streamed.
    for b, l in STREAM_SHAPES:
      q, k, v = (randn(b, l, WIDTH) for _ in range(3))
      keep += [q, k, v]
      q4, k4, v4 = (t.view(b, l, HEADS, 64) for t in (q, k, v))
      for name, stem, inputs in (("K3", "attention_packed", (q, k, v)),
                                 ("K7", "attention_unpacked", (q4, k4, v4))):
        compare(f"{name} streamed {b}x{l}", {
            side: attention_launch(this[stem], f"{stem}_fwd{suffix}",
                                   *inputs, HEADS)
            for side, suffix in (("resident", ""), ("streamed",
                                                    "_streamed"))})

    for b, l in TRAIN_SHAPES:
      q, k, v, do = (randn(b, l, HEADS, 64) for _ in range(4))
      keep += [q, k, v, do]
      pairs[f"K8 {b}x{l}"] = {}
      for s, libs in sides.items():
        outs = [torch.empty_like(q) for _ in range(3)] + [
            torch.empty(b, HEADS, l, device="cuda") for _ in range(3)]
        keep += outs
        ptrs = [t.data_ptr() for t in (q, k, v, do, *outs)]
        pairs[f"K8 {b}x{l}"][s] = (
            lambda lib=libs["attention_unpacked_bwd"], p=ptrs, b=b, l=l:
            _check(lib.attention_unpacked_bwd(*p, b, l, HEADS, 64, scale,
                                              stream())))
        outputs.setdefault(f"K8 {b}x{l}", {})[s] = outs[:3]
      heads_first = [t.transpose(1, 2).detach().requires_grad_()
                     for t in (q, k, v)]
      o = sdpa(*heads_first)
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
        outputs.setdefault(f"K2 {b}x{l}", {})[side] = outs[:5]
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
               library, outputs)
    randn32 = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    changed = {}
    for b, l in K3_F32_SHAPES:
      f32_attention(sides, b, l, randn32, keep, pairs, outputs, changed)
    for b, l in K6_SHAPES:
      k6_f32(sides, b, l, randn32, keep, pairs, outputs)
    # Each side of K1-K4 (and K4, K6, K8 in f32) and K8 there once; their
    # outputs compared.
    for name, by_side in outputs.items():
      for side in by_side:
        pairs[name][side]()
      torch.cuda.synchronize()
      first, second = by_side.values()
      same_bits[name] = all(torch.equal(a, b)
                            for a, b in zip(first, second))
    # K3 and K7 in f32: each side once, this tree's again (the same bits
    # launch to launch), and the largest difference of the two sides'
    # outputs, relative to each output's largest value.
    close = {}
    for name, by_side in changed.items():
      for side in by_side:
        pairs[name][side]()
      first = [t.clone() for t in by_side["this"]]
      pairs[name]["this"]()
      torch.cuda.synchronize()
      same_bits[f"{name} this, two launches"] = all(
          torch.equal(a, b) for a, b in zip(first, by_side["this"]))
      close[name] = max(
          ((a - b).abs().max() / b.abs().max()).item()
          for a, b in zip(by_side["this"], by_side["other"]))

    # This tree alone at three and four 64-column tiles a head.
    for heads, hd in WIDE_HEADS:
      wide_heads(this, heads, hd, randn, keep, alone, bounds, library)

    # This tree alone at the long shapes.
    for b, l, heads, hd in LONG_SHAPES:
      width = heads * hd
      tag = f"{b}x{l} {heads}x{hd}"
      q, k, v = (randn(b, l, width) for _ in range(3))
      q4, k4, v4 = (t.view(b, l, heads, hd) for t in (q, k, v))
      x = randn(b, l, width)
      wide = []
      for _ in range(4):
        wide += [randn(width, width, std=width**-0.5), randn(width, std=0.1)]
      keep += [q, k, v, x, *wide]
      launches = {
          "K3": attention_launch(this["attention_packed"],
                                 "attention_packed_fwd", q, k, v, heads),
          "K7": attention_launch(this["attention_unpacked"],
                                 "attention_unpacked_fwd", q4, k4, v4,
                                 heads)}
      for arm_id, arm in enumerate(attn.ABLATE_VARIANTS):
        launches[f"K9 {arm}"] = attention_launch(
            this["attention_ablate"], "attention_ablate_fwd", q, k, v, heads,
            arm_id)
      k6, o6 = k6_launches(this["fused_mha"], x, wide, b, l, width, heads)
      launches["K6 call"] = (k6["call"], o6)
      launches["K6 attention"] = (k6["attention"], o6)
      for name, (fn, out) in launches.items():
        alone[f"{name} {tag}"] = fn
        bounds[f"{name} {tag}"] = bound_ms(b, l, heads, hd)
        keep.append(out)
      library[f"long {tag}"] = (
          lambda hf=[t.transpose(1, 2) for t in (q4, k4, v4)]: sdpa(*hf))

    times = {name: {side: [] for side in fns} for name, fns in pairs.items()}
    alone_times = {name: [] for name in alone}
    lib_times = {name: [] for name in library}
    for _ in range(args.rounds):
      for name, fns in pairs.items():
        first, second = fns
        for side in (first, second, second, first):
          times[name][side].append(dev_ms(fns[side], args.iters))
      for name, fn in alone.items():
        alone_times[name].append(dev_ms(fn, args.iters))
      for name, fn in library.items():
        lib_times[name].append(dev_ms(fn, args.iters))

  summary = lambda v: dict(median=statistics.median(v), min=min(v),
                           max=max(v))
  result = {"card": card, "same_bits": same_bits, "f32_fwd_vs_other": close,
            "times": {name: {side: summary(v) for side, v in t.items()}
                      for name, t in times.items()},
            "alone": {name: summary(v) for name, v in alone_times.items()},
            "library": {name: summary(v) for name, v in lib_times.items()},
            "bound_ms": bounds}
  print(f"[ab_kernels] bit-equal: {same_bits}; on {card}", flush=True)
  print(f"[ab_kernels] K3 and K7 in f32 (3xTF32 here), this against other, "
        f"the largest difference of each output's largest value: {close}",
        flush=True)
  for name, t in result["times"].items():
    (a, ta), (b, tb) = t.items()
    print(f"[ab_kernels] {name}: {b} {tb['median']:.4f} ms "
          f"({tb['min']:.4f}-{tb['max']:.4f}), {a} {ta['median']:.4f} "
          f"({ta['min']:.4f}-{ta['max']:.4f}), {b}/{a} "
          f"{tb['median'] / ta['median']:.3f}", flush=True)
  for name, t in result["alone"].items():
    print(f"[ab_kernels] {name}: this {t['median']:.4f} ms "
          f"({t['min']:.4f}-{t['max']:.4f}), bound of the attention "
          f"{bounds[name]:.4f}", flush=True)
  for name, t in result["library"].items():
    print(f"[ab_kernels] {name} library: {t['median']:.4f} ms "
          f"({t['min']:.4f}-{t['max']:.4f})", flush=True)
  if args.out:
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
  if not all(same_bits.values()):
    raise SystemExit("ab_kernels: bits differ: " + ", ".join(
        name for name, same in same_bits.items() if not same))
  far = {name: d for name, d in close.items() if not d <= 1e-4}
  if far:
    raise SystemExit(f"ab_kernels: the f32 forwards differ by more than "
                     f"1e-4 of their outputs: {far}")
  return result


if __name__ == "__main__":
  main()
