"""Smoke run of the PyTorch/CUDA port (small_vision_tpu_torch) on one GPU.

  python3 chip_smoke.py

Phases, each fatal on failure:
  1. build     nvcc builds every kernel under small_vision_tpu_torch/csrc/.
  2. kernels   each kernel against its plain PyTorch version on the card,
               with its time, the plain version's, one library call's and
               the bound: the forwards K1, K3, K7 at the shapes of the
               UMD-B/4@64 sampler at batch 64 (L = 260 and 257; K7 also at
               the shape of phase 6), the backwards K2, K4, K8 at the
               training shapes (per-branch batch 128, L = 68, 164, 257),
               each launched twice to show equal bits, the fused MLP
               and MHA (K5, K6) at both, and the seven arms of the ablation
               kernel (K9) at the tool's two shapes.
  3. model     at full width (depth cut to 2 + 1), on the card (kernels)
               against the CPU (plain versions), same weights and inputs,
               under attn_impl "pallas" and "pallas_fused": the sampler's
               forward, and one training step's loss and gradients at
               batch 8 with injected draws.
  4. train     the full UMD-B/4@64 training step at batch 256 on synthetic
               data through `train_and_evaluate` (what the CLI runs), from
               `init_train_params` weights, under both settings: 1 warm-up
               and 5 timed steps; finite, falling losses, changed
               parameters, and exactly the kernel launches per step the
               model says.
  5. serve     the port's HTTP sampling server at full UMD-B/4@64 size from
               seeded random weights: three concurrent requests (16, 16, 32
               images) coalesce into one 125-step DDIM call of batch 64; the
               kernel launch counts of that call must be what the model says
               (and no backward kernel). Then one such call under
               "pallas_fused" through `build_sample_callable`, counted the
               same way.
  6. unpacked  `ops.attention.fused_attention`, the [B, L, H, D] entry
               point that no module of the model calls, forward and
               backward through autograd at the decoder's training shape:
               one K7 and one K8 launch, against the CPU.
  7. ablate    the attention-ablation tool
               (`tools/ablate_attention_kernel.py::main`) at its two shapes:
               the seven arms of K9, 21 launches each, beside K3 and SDPA.
  8. resume    full-width UMD-B/4@64 at batch 256 through
               `train_and_evaluate` with a workdir: run A trains 6 steps
               with a checkpoint every 3 and the `val` and `mae_val`
               evaluators (2 batches each) at step 6; run B stops after
               step 3's checkpoint and a fresh call on its workdir resumes
               at step 4. The two step-6 states must be equal bit for bit,
               the metrics file complete and finite, and a planted
               half-written checkpoint directory ignored and removed. Also
               times one `save` (the loop's blocking part and the
               background write).
Then it prints the card's name and power limit, one JSON line of the
kernels, and as its last line {"ok": true, "device": {...}}. Without a CUDA
device it exits non-zero and prints no result.
"""

import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12         # dense tensor-core bf16
F32_FLOPS = 67e12           # f32 outside the tensor cores

BATCH = 64
WIDTH, HEADS = 768, 12
SEQ_ENC, SEQ_DEC = 260, 257   # 256 patches + 4 cls; 256 patches + 1 rep
SAMPLER_FORWARDS = 126        # 125 DDIM steps + the final t=0 step
BLOCKS = 12 + 4               # encoder + decoder blocks of UMD-B/4
TRAIN_BATCH = 256             # per card; each branch gets half
TRAIN_SEQS = (68, 164, 257)   # MAE encoder, diffusion encoder, decoders
MLP_DIM = 3072
TRAIN_STEPS = 6               # 1 warm-up + 5 timed
ATTN_IMPLS = ("pallas", "pallas_fused")
# Kernel launches of one block applied once, with gradients (training) and
# without (the sampler). Under "pallas_fused" the fused forwards replace
# the packed attention's, which then runs in the backward only: FusedMHA
# recomputes its reference composition there (K3) and differentiates it
# (K4).
BLOCK_TRAIN_LAUNCHES = {
    "pallas": {"ln_modulate_fwd": 2, "ln_modulate_bwd": 2,
               "attention_packed_fwd": 1, "attention_packed_bwd": 1},
    "pallas_fused": {"ln_modulate_fwd": 2, "ln_modulate_bwd": 2,
                     "fused_mha_fwd": 1, "fused_mlp_fwd": 1,
                     "attention_packed_fwd": 1, "attention_packed_bwd": 1},
}
BLOCK_SAMPLE_LAUNCHES = {
    "pallas": {"ln_modulate_fwd": 2, "attention_packed_fwd": 1},
    "pallas_fused": {"ln_modulate_fwd": 2, "fused_mha_fwd": 1,
                     "fused_mlp_fwd": 1},
}


def _times(per_block, n):
  return {k: n * v for k, v in per_block.items()}


def fail(msg):
  print(f"FAILED: {msg}", flush=True)
  sys.exit(1)


def time_ms(fn, iters=50, warmup=3):
  """Mean device time of one call, by CUDA events over `iters` calls."""
  for _ in range(warmup):
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


def card_line():
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  return out.stdout.strip().splitlines()[0]


def phase_build(build):
  t0 = time.perf_counter()
  libs = build.build_all()
  print(f"[build] {len(libs)} kernel libraries ({', '.join(sorted(libs))}) "
        f"built in {time.perf_counter() - t0:.2f} s", flush=True)


def _bound(bytes_moved, ops, peak):
  """(least ms, "bytes" or "operations"): the larger of the bytes over the
  memory rate and the operations over the peak rate of their type."""
  bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
  ops_ms = ops / peak * 1e3
  return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def check_ln(ln, card):
  """K1 against its plain version; returns its kernels-line entry."""
  gen = torch.Generator(device="cuda").manual_seed(0)
  randn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
  gamma = 1.0 + 0.1 * randn(WIDTH)
  beta = 0.1 * randn(WIDTH)
  # shift/scale as the block makes them: column slices of the AdaLN output.
  mods = (0.5 * randn(BATCH, 6 * WIDTH)).to(torch.bfloat16)
  shift, scale = mods.chunk(6, dim=-1)[:2]
  max_err, timing = 0.0, None
  for seq in (SEQ_ENC, SEQ_DEC):
    x = (2.0 * randn(BATCH, seq, WIDTH) + 0.5).to(torch.bfloat16)
    for mod in ((shift, scale), (None, None)):
      args = (x, gamma, beta, *mod)
      y = ln.ln_modulate_fwd(*args).float()
      ref = ln.ln_modulate_plain(*args).float()
      torch.cuda.synchronize()
      err = (y - ref).abs()
      # One bf16 ulp of the output (2^-7 relative), plus f32 rounding of
      # the O(1) intermediates, which may tip a value across a bf16 tie.
      bad = (err > 2.0**-7 * ref.abs() + 1e-5).sum().item()
      max_err = max(max_err, err.max().item())
      print(f"[kernels] ln_modulate_fwd L={seq} "
            f"modulate={mod[0] is not None}: max abs err "
            f"{err.max().item():.3e}, {bad} elements over 1 bf16 ulp",
            flush=True)
      if bad:
        fail(f"ln_modulate_fwd disagrees with its plain version ({bad})")
    if seq == SEQ_ENC:
      args = (x, gamma, beta, shift, scale)
      g16, b16 = gamma.to(x.dtype), beta.to(x.dtype)
      timing = dict(
          ms=time_ms(lambda: ln.ln_modulate_fwd(*args)),
          plain_ms=time_ms(lambda: ln.ln_modulate_plain(*args)),
          library_ms=time_ms(lambda: torch.nn.functional.layer_norm(
              x, (WIDTH,), g16, b16, 1e-6) * (1 + scale[:, None])
                             + shift[:, None]))
  n = BATCH * SEQ_ENC * WIDTH
  bytes_moved = 2 * n * 2 + 2 * WIDTH * 4 + 2 * BATCH * WIDTH * 2
  bound_ms, bound_by = _bound(bytes_moved, 9 * n, F32_FLOPS)
  print(f"[kernels] ln_modulate_fwd B={BATCH} L={SEQ_ENC} D={WIDTH} "
        f"modulated: kernel {timing['ms']:.4f} ms, plain "
        f"{timing['plain_ms']:.4f} ms, layer_norm+modulate "
        f"{timing['library_ms']:.4f} ms, bound {bound_ms:.4f} "
        f"ms ({bytes_moved} bytes) on {card}", flush=True)
  return dict(name=ln.NAME, route="cuda",
              source="small_vision_tpu_torch/csrc/ln_modulate.cu",
              replaces="small_vision_tpu/ops/layernorm.py:58",
              max_abs_err=max_err, bound_ms=bound_ms, bound_by=bound_by,
              **timing)


def check_attention(attn, card):
  """K3 against its plain version; returns its kernels-line entry."""
  gen = torch.Generator(device="cuda").manual_seed(1)
  max_err, timing = 0.0, None
  head_dim = WIDTH // HEADS
  for seq in (SEQ_ENC, SEQ_DEC):
    q, k, v = (torch.randn(BATCH, seq, WIDTH, generator=gen,
                           device="cuda").to(torch.bfloat16)
               for _ in range(3))
    o = attn.attention_packed_fwd(q, k, v, HEADS).float()
    ref = attn.attention_packed_plain(q, k, v, HEADS).float()
    torch.cuda.synchronize()
    err = (o - ref).abs()
    # Two bf16 ulps at unit magnitude (outputs are convex mixes of N(0,1)
    # values): the f32 score sums run in another order, which may round a
    # weight e to the neighbouring bf16 value, and o itself is bf16.
    bad = (err > 1e-2 + 1e-2 * ref.abs()).sum().item()
    max_err = max(max_err, err.max().item())
    print(f"[kernels] attention_packed_fwd L={seq}: max abs err "
          f"{err.max().item():.3e}, {bad} elements over tolerance",
          flush=True)
    if bad:
      fail(f"attention_packed_fwd disagrees with its plain version ({bad})")
    if seq == SEQ_ENC:
      split = lambda t: t.view(BATCH, seq, HEADS, head_dim).transpose(1, 2)
      timing = dict(
          ms=time_ms(lambda: attn.attention_packed_fwd(q, k, v, HEADS)),
          plain_ms=time_ms(lambda: attn.attention_packed_plain(q, k, v,
                                                               HEADS),
                           iters=10),
          library_ms=time_ms(
              lambda: torch.nn.functional.scaled_dot_product_attention(
                  split(q), split(k), split(v))))
  bytes_moved = 4 * BATCH * SEQ_ENC * WIDTH * 2
  flops = 4 * BATCH * HEADS * SEQ_ENC * SEQ_ENC * head_dim
  bound_ms, bound_by = _bound(bytes_moved, flops, BF16_FLOPS)
  print(f"[kernels] attention_packed_fwd B={BATCH} L={SEQ_ENC} H={HEADS} "
        f"D={head_dim}: kernel {timing['ms']:.4f} ms, plain "
        f"{timing['plain_ms']:.4f} ms, sdpa {timing['library_ms']:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bytes_moved} bytes, "
        f"{flops} flops) on {card}", flush=True)
  return dict(name=attn.NAME, route="cuda",
              source="small_vision_tpu_torch/csrc/attention_packed.cu",
              replaces="small_vision_tpu/ops/attention.py:258",
              max_abs_err=max_err, bound_ms=bound_ms, bound_by=bound_by,
              **timing)


def check_ln_bwd(ln, card):
  """K2 against its plain version at the training shapes."""
  gen = torch.Generator(device="cuda").manual_seed(2)
  randn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
  b = TRAIN_BATCH // 2
  gamma = 1.0 + 0.1 * randn(WIDTH)
  beta = 0.1 * randn(WIDTH)
  mods = (0.5 * randn(b, 6 * WIDTH)).to(torch.bfloat16)
  shift, scale = mods.chunk(6, dim=-1)[:2]
  max_err, by_len = 0.0, {}
  for seq in TRAIN_SEQS:
    x = (2.0 * randn(b, seq, WIDTH) + 0.5).to(torch.bfloat16)
    dy = randn(b, seq, WIDTH).to(torch.bfloat16)
    mean = torch.empty(b, seq, device="cuda")
    rstd = torch.empty_like(mean)
    ln.ln_modulate_fwd(x, gamma, beta, shift, scale, mean=mean, rstd=rstd)
    for sc in (scale, None):
      args = (x, dy, mean, rstd, gamma, beta, sc)
      got = ln.ln_modulate_bwd(*args)
      again = ln.ln_modulate_bwd(*args)
      want = ln.ln_modulate_bwd_plain(*args)
      torch.cuda.synchronize()
      if not all(torch.equal(g, a) for g, a in zip(got, again)
                 if g is not None):
        fail(f"ln_modulate_bwd L={seq}: two launches differ")
      dx, dx_want = got[0].float(), want[0].float()
      err = (dx - dx_want).abs()
      # dx: one bf16 ulp (rounding either way) plus f32 noise; the sums:
      # f32 sums of 128*L O(1) terms in another order, relative to the
      # largest.
      bad = int((err > 2.0**-7 * dx_want.abs() + 1e-3).sum())
      worst = err.max().item()
      for g, w in zip(got[1:], want[1:]):
        if w is not None:
          e = (g - w).abs().max().item()
          worst = max(worst, e)
          bad += int(e > 1e-4 * w.abs().max().item())
      max_err = max(max_err, worst)
      print(f"[kernels] ln_modulate_bwd B={b} L={seq} modulate="
            f"{sc is not None}: max abs err {worst:.3e}, {bad} over "
            "tolerance, two launches equal", flush=True)
      if bad:
        fail(f"ln_modulate_bwd disagrees with its plain version ({bad})")
    args = (x, dy, mean, rstd, gamma, beta, scale)
    # The library yardstick: autograd of F.layer_norm + modulate, on a
    # retained graph.
    xg = x.clone().requires_grad_()
    g16 = gamma.to(torch.bfloat16).requires_grad_()
    b16 = beta.to(torch.bfloat16).requires_grad_()
    sh, scl = (t.clone().requires_grad_() for t in (shift, scale))
    y = (torch.nn.functional.layer_norm(xg, (WIDTH,), g16, b16, 1e-6)
         * (1 + scl[:, None]) + sh[:, None])
    n = b * seq * WIDTH
    bound_ms, bound_by = _bound(
        3 * n * 2 + 2 * b * seq * 4 + 4 * WIDTH * 4 + b * WIDTH * 2
        + 2 * b * WIDTH * 4, 14 * n, F32_FLOPS)
    by_len[seq] = dict(
        ms=time_ms(lambda: ln.ln_modulate_bwd(*args)),
        plain_ms=time_ms(lambda: ln.ln_modulate_bwd_plain(*args), iters=10),
        library_ms=time_ms(lambda: torch.autograd.grad(
            y, (xg, g16, b16, sh, scl), dy, retain_graph=True)),
        bound_ms=bound_ms, bound_by=bound_by)
    print(f"[kernels] ln_modulate_bwd B={b} L={seq} D={WIDTH} modulated: "
          + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                      for k, v in by_len[seq].items()) + f" on {card}",
          flush=True)
  return dict(name=ln.BWD_NAME, route="cuda",
              source="small_vision_tpu_torch/csrc/ln_modulate_bwd.cu",
              replaces="small_vision_tpu/ops/layernorm.py:130",
              max_abs_err=max_err, **by_len[TRAIN_SEQS[-1]],
              by_len=by_len)


def check_attention_bwd(attn, card):
  """K4 against its plain version at the training shapes."""
  gen = torch.Generator(device="cuda").manual_seed(3)
  b = TRAIN_BATCH // 2
  head_dim = WIDTH // HEADS
  max_err, by_len = 0.0, {}
  for seq in TRAIN_SEQS:
    q, k, v, do = (torch.randn(b, seq, WIDTH, generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    got = attn.attention_packed_bwd(q, k, v, do, HEADS)
    again = attn.attention_packed_bwd(q, k, v, do, HEADS)
    want = attn.attention_packed_bwd_plain(q, k, v, do, HEADS)
    torch.cuda.synchronize()
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
      fail(f"attention_packed_bwd L={seq}: two launches differ")
    worst, bad = 0.0, 0
    for g, w in zip(got, want):
      # bf16 outputs of f32 sums over L; a sum in another order may flip
      # the bf16 rounding of an e, dO*r or dS input of a product: a few
      # bf16 ulps of the largest output.
      e = (g.float() - w.float()).abs().max().item()
      worst = max(worst, e)
      bad += int(e > 2.0**-6 * w.float().abs().max().item())
    max_err = max(max_err, worst)
    print(f"[kernels] attention_packed_bwd B={b} L={seq}: max abs err "
          f"{worst:.3e}, {bad} outputs over tolerance, two launches equal",
          flush=True)
    if bad:
      fail(f"attention_packed_bwd disagrees with its plain version ({bad})")
    split = lambda t: t.view(b, seq, HEADS, head_dim).transpose(1, 2)
    qs, ks, vs = (split(t).detach().requires_grad_() for t in (q, k, v))
    o = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)
    dos = split(do)
    bound_ms, bound_by = _bound(7 * b * seq * WIDTH * 2,
                                5 * 2 * b * HEADS * seq * seq * head_dim,
                                BF16_FLOPS)
    by_len[seq] = dict(
        ms=time_ms(lambda: attn.attention_packed_bwd(q, k, v, do, HEADS)),
        plain_ms=time_ms(lambda: attn.attention_packed_bwd_plain(
            q, k, v, do, HEADS), iters=5),
        library_ms=time_ms(lambda: torch.autograd.grad(
            o, (qs, ks, vs), dos, retain_graph=True)),
        bound_ms=bound_ms, bound_by=bound_by)
    print(f"[kernels] attention_packed_bwd B={b} L={seq} H={HEADS} "
          f"D={head_dim}: " + ", ".join(
              f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
              for k, v in by_len[seq].items()) + f" on {card}", flush=True)
  return dict(name=attn.BWD_NAME, route="cuda",
              source="small_vision_tpu_torch/csrc/attention_packed_bwd.cu",
              replaces="small_vision_tpu/ops/attention.py:343",
              max_abs_err=max_err, **by_len[TRAIN_SEQS[-1]],
              by_len=by_len)


def _fmt(entry):
  return ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                   for k, v in entry.items())


def _close_to_max(got, want, ulps):
  """(max abs err, ok): within `ulps` bf16 ulps of the largest value of
  `want`, an ulp taken as 2^-7 of it (the spacing of bf16 values lies
  between 2^-8 and 2^-7 of their magnitude)."""
  got, want = got.float(), want.float()
  err = (got - want).abs().max().item()
  return err, err <= ulps * 2.0**-7 * want.abs().max().item()


# (batch, length) of the fused kernels' calls: the sampler's encoder and
# decoder, and the three training shapes.
FUSED_SHAPES = ((BATCH, SEQ_ENC), (BATCH, SEQ_DEC)) + tuple(
    (TRAIN_BATCH // 2, l) for l in TRAIN_SEQS)


def check_fused_mlp(fb, card):
  """K5 against its plain version at the sampler's and training shapes."""
  gen = torch.Generator(device="cuda").manual_seed(4)
  randn = lambda *s, std=1.0: (torch.randn(*s, generator=gen, device="cuda")
                               * std).to(torch.bfloat16)
  w1, b1 = randn(WIDTH, MLP_DIM, std=WIDTH**-0.5), randn(MLP_DIM, std=0.1)
  w2, b2 = randn(MLP_DIM, WIDTH, std=MLP_DIM**-0.5), randn(WIDTH, std=0.1)
  lin = torch.nn.functional.linear
  w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
  max_err, by_shape = 0.0, {}
  for b, seq in FUSED_SHAPES:
    x = randn(b, seq, WIDTH)
    args = (x, w1, b1, w2, b2)
    got = fb.fused_mlp_fwd(*args)
    want = fb.fused_mlp_plain(*args)
    torch.cuda.synchronize()
    # bf16 hidden activations and outputs on both sides; f32 sums over 768
    # and 3,072 terms in another order may flip the rounding of a hidden
    # value, which moves an output by about one bf16 ulp: allow two ulps of
    # the largest output.
    err, ok = _close_to_max(got, want, 2)
    max_err = max(max_err, err)
    print(f"[kernels] fused_mlp_fwd B={b} L={seq}: max abs err {err:.3e} of "
          f"max {want.float().abs().max().item():.3e} (tolerance 2 bf16 "
          "ulps of the max)", flush=True)
    if not ok:
      fail(f"fused_mlp_fwd disagrees with its plain version ({err:.3e})")
    rows = b * seq
    bytes_moved = (2 * rows * WIDTH + 2 * WIDTH * MLP_DIM + MLP_DIM
                   + WIDTH) * 2
    flops = 4 * rows * WIDTH * MLP_DIM
    bound_ms, bound_by = _bound(bytes_moved, flops, BF16_FLOPS)
    by_shape[f"{b}x{seq}"] = dict(
        ms=time_ms(lambda: fb.fused_mlp_fwd(*args), iters=20),
        plain_ms=time_ms(lambda: fb.fused_mlp_plain(*args), iters=3,
                         warmup=1),
        library_ms=time_ms(lambda: lin(torch.nn.functional.gelu(
            lin(x, w1t, b1), approximate="tanh"), w2t, b2), iters=20),
        bound_ms=bound_ms, bound_by=bound_by)
    print(f"[kernels] fused_mlp_fwd B={b} L={seq} D={WIDTH} hidden="
          f"{MLP_DIM}: {_fmt(by_shape[f'{b}x{seq}'])} ({bytes_moved} bytes, "
          f"{flops} flops) on {card}", flush=True)
  return dict(name=fb.MLP_NAME, route="cuda",
              source="small_vision_tpu_torch/csrc/fused_mlp.cu",
              replaces="small_vision_tpu/ops/fused_block.py:185",
              max_abs_err=max_err, **by_shape[f"{BATCH}x{SEQ_ENC}"],
              by_shape=by_shape)


def check_fused_mha(fb, card):
  """K6 against its plain version at the sampler's and training shapes;
  two launches must give equal bits."""
  gen = torch.Generator(device="cuda").manual_seed(5)
  randn = lambda *s, std=1.0: (torch.randn(*s, generator=gen, device="cuda")
                               * std).to(torch.bfloat16)
  params = []
  for _ in range(4):
    params += [randn(WIDTH, WIDTH, std=WIDTH**-0.5), randn(WIDTH, std=0.1)]
  wq, bq, wk, bk, wv, bv, wo, bo = params
  lin = torch.nn.functional.linear
  wts = [w.t().contiguous() for w in (wq, wk, wv, wo)]
  head_dim = WIDTH // HEADS
  max_err, by_shape = 0.0, {}
  for b, seq in FUSED_SHAPES:
    x = randn(b, seq, WIDTH)
    args = (x, *params, HEADS)
    got = fb.fused_mha_fwd(*args)
    again = fb.fused_mha_fwd(*args)
    want = fb.fused_mha_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
      fail(f"fused_mha_fwd B={b} L={seq}: two launches differ")
    # q, k, v, the probabilities, the head outputs and the output round to
    # bf16 on both sides; sums in another order may flip an inner rounding,
    # which moves an output by about one bf16 ulp: allow two ulps of the
    # largest output.
    err, ok = _close_to_max(got, want, 2)
    max_err = max(max_err, err)
    print(f"[kernels] fused_mha_fwd B={b} L={seq}: max abs err {err:.3e} of "
          f"max {want.float().abs().max().item():.3e} (tolerance 2 bf16 "
          "ulps of the max), two launches equal", flush=True)
    if not ok:
      fail(f"fused_mha_fwd disagrees with its plain version ({err:.3e})")

    def library():
      split = lambda t: t.view(b, seq, HEADS, head_dim).transpose(1, 2)
      q, k, v = (split(lin(x, w, bias)) for w, bias in
                 zip(wts[:3], (bq, bk, bv)))
      o = torch.nn.functional.scaled_dot_product_attention(q, k, v)
      return lin(o.transpose(1, 2).reshape(b, seq, WIDTH), wts[3], bo)

    bytes_moved = (2 * b * seq * WIDTH + 4 * WIDTH * WIDTH + 4 * WIDTH) * 2
    flops = (8 * b * seq * WIDTH * WIDTH
             + 4 * b * HEADS * seq * seq * head_dim)
    bound_ms, bound_by = _bound(bytes_moved, flops, BF16_FLOPS)
    by_shape[f"{b}x{seq}"] = dict(
        ms=time_ms(lambda: fb.fused_mha_fwd(*args), iters=20),
        plain_ms=time_ms(lambda: fb.fused_mha_plain(*args), iters=3,
                         warmup=1),
        library_ms=time_ms(library, iters=20),
        bound_ms=bound_ms, bound_by=bound_by)
    print(f"[kernels] fused_mha_fwd B={b} L={seq} D={WIDTH} H={HEADS}: "
          f"{_fmt(by_shape[f'{b}x{seq}'])} ({bytes_moved} bytes, {flops} "
          f"flops) on {card}", flush=True)
  return dict(name=fb.MHA_NAME, route="cuda",
              source="small_vision_tpu_torch/csrc/fused_mha.cu",
              replaces="small_vision_tpu/ops/fused_block.py:68",
              max_abs_err=max_err, **by_shape[f"{BATCH}x{SEQ_ENC}"],
              by_shape=by_shape)


def check_attention_unpacked(attn, card):
  """K7 against its plain version at the sampler's shapes and at the shape
  phase `unpacked` launches it at; timed at the first."""
  gen = torch.Generator(device="cuda").manual_seed(6)
  head_dim = WIDTH // HEADS
  max_err, timing = 0.0, None
  for b, seq in ((BATCH, SEQ_ENC), (BATCH, SEQ_DEC),
                 (TRAIN_BATCH // 2, TRAIN_SEQS[-1])):
    q, k, v = (torch.randn(b, seq, HEADS, head_dim, generator=gen,
                           device="cuda").to(torch.bfloat16)
               for _ in range(3))
    o = attn.attention_unpacked_fwd(q, k, v).float()
    ref = attn.attention_plain(q, k, v).float()
    torch.cuda.synchronize()
    err = (o - ref).abs()
    # Two bf16 ulps at unit magnitude (outputs are convex mixes of N(0,1)
    # values): the f32 score sums run in another order, which may round a
    # probability to the neighbouring bf16 value, and o itself is bf16.
    bad = (err > 1e-2 + 1e-2 * ref.abs()).sum().item()
    max_err = max(max_err, err.max().item())
    print(f"[kernels] attention_unpacked_fwd B={b} L={seq}: max abs err "
          f"{err.max().item():.3e}, {bad} elements over tolerance",
          flush=True)
    if bad:
      fail(f"attention_unpacked_fwd disagrees with its plain version ({bad})")
    if timing is None:
      heads_first = lambda t: t.transpose(1, 2)
      timing = dict(
          ms=time_ms(lambda: attn.attention_unpacked_fwd(q, k, v)),
          plain_ms=time_ms(lambda: attn.attention_plain(q, k, v), iters=10),
          library_ms=time_ms(
              lambda: torch.nn.functional.scaled_dot_product_attention(
                  heads_first(q), heads_first(k), heads_first(v))))
  bytes_moved = 4 * BATCH * SEQ_ENC * WIDTH * 2
  flops = 4 * BATCH * HEADS * SEQ_ENC * SEQ_ENC * head_dim
  bound_ms, bound_by = _bound(bytes_moved, flops, BF16_FLOPS)
  print(f"[kernels] attention_unpacked_fwd B={BATCH} L={SEQ_ENC} H={HEADS} "
        f"D={head_dim}: {_fmt(timing)}, bound {bound_ms:.4f} ms "
        f"({bytes_moved} bytes, {flops} flops) on {card}", flush=True)
  return dict(name=attn.UNPACKED_NAME, route="cuda",
              source="small_vision_tpu_torch/csrc/attention_unpacked.cu",
              replaces="small_vision_tpu/ops/attention.py:79",
              max_abs_err=max_err, bound_ms=bound_ms, bound_by=bound_by,
              **timing)


def check_attention_unpacked_bwd(attn, card):
  """K8 against its plain version at the training shapes."""
  gen = torch.Generator(device="cuda").manual_seed(7)
  b = TRAIN_BATCH // 2
  head_dim = WIDTH // HEADS
  max_err, by_len = 0.0, {}
  for seq in TRAIN_SEQS:
    q, k, v, do = (torch.randn(b, seq, HEADS, head_dim, generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    got = attn.attention_unpacked_bwd(q, k, v, do)
    again = attn.attention_unpacked_bwd(q, k, v, do)
    want = attn.attention_bwd_plain(q, k, v, do)
    torch.cuda.synchronize()
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
      fail(f"attention_unpacked_bwd L={seq}: two launches differ")
    worst, bad = 0.0, 0
    for g, w in zip(got, want):
      # bf16 outputs of f32 sums over L; a sum in another order may flip
      # the bf16 rounding of a P or dS input of a product: a few bf16 ulps
      # of the largest output.
      e = (g.float() - w.float()).abs().max().item()
      worst = max(worst, e)
      bad += int(e > 2.0**-6 * w.float().abs().max().item())
    max_err = max(max_err, worst)
    print(f"[kernels] attention_unpacked_bwd B={b} L={seq}: max abs err "
          f"{worst:.3e}, {bad} outputs over tolerance, two launches equal",
          flush=True)
    if bad:
      fail(f"attention_unpacked_bwd disagrees with its plain version ({bad})")
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    o = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)
    dos = do.transpose(1, 2)
    bound_ms, bound_by = _bound(7 * b * seq * WIDTH * 2,
                                5 * 2 * b * HEADS * seq * seq * head_dim,
                                BF16_FLOPS)
    by_len[seq] = dict(
        ms=time_ms(lambda: attn.attention_unpacked_bwd(q, k, v, do)),
        plain_ms=time_ms(lambda: attn.attention_bwd_plain(q, k, v, do),
                         iters=5),
        library_ms=time_ms(lambda: torch.autograd.grad(
            o, (qs, ks, vs), dos, retain_graph=True)),
        bound_ms=bound_ms, bound_by=bound_by)
    print(f"[kernels] attention_unpacked_bwd B={b} L={seq} H={HEADS} "
          f"D={head_dim}: {_fmt(by_len[seq])} on {card}", flush=True)
  return dict(name=attn.UNPACKED_BWD_NAME, route="cuda",
              source="small_vision_tpu_torch/csrc/attention_unpacked_bwd.cu",
              replaces="small_vision_tpu/ops/attention.py:162",
              max_abs_err=max_err, **by_len[TRAIN_SEQS[-1]], by_len=by_len)


ABLATE_SHAPES = ((128, 257), (128, 164))  # the ablation tool's (B, L)
# Tolerance of each arm of K9 in bf16 ulps of the largest output (an ulp
# taken as 2^-7 of it). The softmax arms and nosoftmax round p to bf16 on
# both sides from f32 scores summed in another order, which may flip a p
# to its neighbour, and the output is bf16: two ulps. nomm has no sum whose
# order could differ (e = exp(0) = 1, the row sum is L, one exact product):
# half an ulp, one rounding. bf16exp rounds the shifted score to bf16
# before exp, so a flipped rounding moves that e by up to 2^-8 |S - m|, a
# few per cent for the far keys: four ulps.
ABLATE_ULPS = {"prod": 2, "nosoftmax": 2, "nomm": 0.5, "bf16exp": 4,
               "exp2": 2, "mulmask": 2, "nomax": 2}


def check_attention_ablate(attn, card):
  """K9, all seven arms at the tool's two shapes, against its plain version;
  returns its kernels-line entry (times of `prod` at L = 257 on top, every
  arm's under `by_shape`)."""
  gen = torch.Generator(device="cuda").manual_seed(9)
  head_dim = WIDTH // HEADS
  max_err, by_shape = 0.0, {}
  for b, seq in ABLATE_SHAPES:
    q, k, v = (torch.randn(b, seq, WIDTH, generator=gen,
                           device="cuda").to(torch.bfloat16)
               for _ in range(3))
    split = lambda t: t.view(b, seq, HEADS, head_dim).transpose(1, 2)
    bytes_moved = 4 * b * seq * WIDTH * 2
    flops = 4 * b * HEADS * seq * seq * head_dim
    bound_ms, bound_by = _bound(bytes_moved, flops, BF16_FLOPS)
    library_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            split(q), split(k), split(v)), iters=20)
    arms = {}
    for arm in attn.ABLATE_VARIANTS:
      got = attn.attention_ablate_fwd(q, k, v, HEADS, arm)
      want = attn.attention_ablate_plain(q, k, v, HEADS, arm)
      torch.cuda.synchronize()
      err, ok = _close_to_max(got, want, ABLATE_ULPS[arm])
      max_err = max(max_err, err)
      arms[arm] = dict(
          ms=time_ms(lambda: attn.attention_ablate_fwd(q, k, v, HEADS, arm),
                     iters=20),
          plain_ms=time_ms(lambda: attn.attention_ablate_plain(
              q, k, v, HEADS, arm), iters=3, warmup=1),
          max_abs_err=err)
      print(f"[kernels] attention_ablate {arm} B={b} L={seq}: max abs err "
            f"{err:.3e} of max {want.float().abs().max().item():.3e} "
            f"(tolerance {ABLATE_ULPS[arm]} bf16 ulps of the max); "
            f"{_fmt(arms[arm])}", flush=True)
      if not ok:
        fail(f"attention_ablate {arm} L={seq} disagrees with its plain "
             f"version ({err:.3e})")
    by_shape[f"{b}x{seq}"] = dict(arms=arms, library_ms=library_ms,
                                  bound_ms=bound_ms, bound_by=bound_by)
    print(f"[kernels] attention_ablate B={b} L={seq} H={HEADS} D={head_dim}: "
          f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bytes_moved} "
          f"bytes, {flops} flops) on {card}", flush=True)
  top = by_shape["128x257"]
  return dict(name=attn.ABLATE_NAME, route="cuda",
              source="small_vision_tpu_torch/csrc/attention_ablate.cu",
              replaces="scripts/ablate_attention_kernel.py:46",
              max_abs_err=max_err, ms=top["arms"]["prod"]["ms"],
              plain_ms=top["arms"]["prod"]["plain_ms"],
              library_ms=top["library_ms"], bound_ms=top["bound_ms"],
              bound_by=top["bound_by"], by_shape=by_shape)


def _train_step_grads(config, params, images, draws, dev):
  """(loss, [(flax name, f32 gradient on the CPU)]) of one training step's
  forward and backward on `dev`, from `params` with injected draws."""
  from small_vision_tpu_torch import convert
  from small_vision_tpu_torch.train import train_ae

  model = train_ae.build_model(config, device=dev, trainable=True)
  model.load_state_dict(convert.params_from_jax(params, model))
  names = [n for n, _ in train_ae.named_params(model)]
  opt = train_ae.make_optimizer(config, names, total_steps=10, warmup_steps=1)
  state = train_ae.init_train_state(model, opt, config, device=dev)
  step = train_ae.make_update_fn(model, opt, config, device_pp=None)
  loss, grads = step.loss_and_grads(
      state, {"image": torch.from_numpy(images)},
      {k: torch.from_numpy(v) for k, v in draws.items()})
  return float(loss), [(n, g.float().cpu()) for n, g in zip(names, grads)]


def phase_model(build, card, attn_impl):
  """Full-width model at depth 2 + 1 under `attn_impl`: card (kernels)
  against CPU (plain), the sampler's forward and one training step's loss
  and gradients."""
  from small_vision_tpu_torch import convert
  from small_vision_tpu_torch.configs import ae_i1k
  from small_vision_tpu_torch.train import train_ae

  config = ae_i1k.get_config(f"batch_size=8,attn_impl={attn_impl}")
  config["model"].update(depth=2, dec_depth=1)
  params = convert.init_params(config, seed=1)
  rng = np.random.default_rng(2)
  x_t = rng.standard_normal((3, 64, 64, 3), dtype=np.float32)
  t = np.array([1, 500, 1000])  # the sampler feeds t + 1 for t in 0..999
  preds = {}
  for dev in ("cpu", "cuda"):
    model = train_ae.build_model(config, device=dev)
    model.load_state_dict(convert.params_from_jax(params, model))
    with torch.inference_mode():
      preds[dev] = model(torch.from_numpy(x_t).to(dev),
                         t=torch.from_numpy(t).to(dev))[0].cpu()
  err = (preds["cuda"] - preds["cpu"]).abs().max().item()
  scale = preds["cpu"].abs().max().item()
  print(f"[model] {attn_impl}: forward (3, 64, 64, 3) at width {WIDTH}, "
        f"depth 2+1, t = {t.tolist()}: max abs err {err:.3e} of max |pred| "
        f"{scale:.3e}", flush=True)
  # bf16 matmuls summed in another order on the two devices: a few bf16
  # roundings (2^-8 relative each) through three blocks and the head.
  if not err <= 3e-2 * scale:
    fail(f"model forward on the card differs from the CPU by {err:.3e}")

  # One training step at batch 8 (4 + 4), with draws made here.
  n = 8 // 2
  draws = {"t": rng.integers(0, 1000, (n,)),
           "noise": rng.standard_normal((n, 64, 64, 3), dtype=np.float32),
           "mae_noise": rng.random((n, 256), dtype=np.float32),
           "dit_noise": rng.random((n, 256), dtype=np.float32)}
  images = rng.uniform(-1, 1, (8, 64, 64, 3)).astype(np.float32)
  loss_cpu, grads_cpu = _train_step_grads(config, params, images, draws,
                                          "cpu")
  build.reset_launches()
  loss_gpu, grads_gpu = _train_step_grads(config, params, images, draws,
                                          "cuda")
  launches = dict(build.LAUNCHES)
  # Two branches of 2 + 1 blocks.
  want = _times(BLOCK_TRAIN_LAUNCHES[attn_impl], 6)
  if launches != want:
    fail(f"training step launches {launches} != {want}")
  # Each leaf's gradient relative to its largest element, with a floor of
  # 1e-3 of the largest gradient of any leaf for the leaves whose gradient
  # is 0 analytically and round-off in practice (the key biases: a shift of
  # all of a query's scores does not change its softmax). bf16 activations
  # and bf16 K2/K4 outputs, rounded at ties that the two sides' summation
  # orders split differently: a few bf16 roundings (2^-8 each) per leaf.
  top = max(g.abs().max().item() for _, g in grads_cpu)
  worst, worst_name = 0.0, None
  for (name, gc), (_, gg) in zip(grads_cpu, grads_gpu):
    rel = ((gg - gc).abs().max().item()
           / max(gc.abs().max().item(), 1e-3 * top))
    if rel > worst:
      worst, worst_name = rel, name
  loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
  print(f"[model] {attn_impl}: training step (8, 64, 64, 3) at width "
        f"{WIDTH}, depth 2+1: loss card {loss_gpu:.6f}, cpu {loss_cpu:.6f} "
        f"(rel {loss_rel:.2e}); "
        f"{len(grads_cpu)} gradient leaves, worst leaf-relative err "
        f"{worst:.3e} ({worst_name}); launches {launches} on {card}",
        flush=True)
  # The loss is an f32 mean over bf16 predictions (see the forward above).
  if not loss_rel <= 1e-2:
    fail(f"training loss on the card differs from the CPU by {loss_rel:.2e}")
  if not worst <= 5e-2:
    fail(f"training gradients on the card differ from the CPU: {worst:.3e} "
         f"of leaf max at {worst_name}")


def phase_train(build, card, attn_impl):
  """The full UMD-B/4@64 training step at batch 256 through
  `train_and_evaluate`, on synthetic data from `init_train_params`, under
  `attn_impl`."""
  from small_vision_tpu_torch.configs import ae_i1k
  from small_vision_tpu_torch.train import train_ae

  config = ae_i1k.get_config(
      f"variant=B/4,size=64,data=synthetic,batch_size={TRAIN_BATCH},"
      f"total_steps={TRAIN_STEPS},log_steps=1,eval_steps=-1,"
      f"attn_impl={attn_impl}")
  build.reset_launches()
  train_state, history = train_ae.train_and_evaluate(
      config, device="cuda",
      log=lambda s: print(f"[train] {attn_impl}: {s}", flush=True))
  launches = dict(build.LAUNCHES)
  n_params = sum(p.numel() for p in train_state["params"])
  del train_state
  torch.cuda.empty_cache()

  timed = history[1:]
  ms = sum(h["ms"] for h in timed) / len(timed)
  print(f"[train] {attn_impl}: UMD-B/4@64, {n_params} parameters, batch "
        f"{TRAIN_BATCH}: {len(timed)} timed steps, mean {ms:.2f} ms/step (min "
        f"{min(h['ms'] for h in timed):.2f}, max "
        f"{max(h['ms'] for h in timed):.2f}) = {TRAIN_BATCH / ms * 1e3:.2f} "
        f"img/s on {card}", flush=True)
  if len(history) != TRAIN_STEPS:
    fail(f"{len(history)} steps ran, not {TRAIN_STEPS}")
  losses = [h["training_loss"] for h in history]
  if not all(np.isfinite(losses)):
    fail(f"non-finite training loss: {losses}")
  if not losses[-1] < losses[0]:
    fail(f"the training loss did not fall: {losses}")
  # Step 1 runs at learning rate 0 (warm-up starts at 0), so its parameter
  # norm is the initial one; the last step's must differ from it.
  if not (history[-1]["l2_params"] != history[0]["l2_params"]
          and history[-1]["l2_updates"] > 0):
    fail("the parameters did not change")
  # Two branches of 12 + 4 blocks a step.
  want = _times(BLOCK_TRAIN_LAUNCHES[attn_impl], 2 * BLOCKS * TRAIN_STEPS)
  print(f"[train] {attn_impl}: kernel launches in {TRAIN_STEPS} steps: "
        f"{launches}, model says {want}", flush=True)
  if launches != want:
    fail(f"launch counts {launches} != {want}")
  return {"img_per_s": TRAIN_BATCH / ms * 1e3, "ms": ms,
          "launches": launches}


def _check_images(images, n):
  if images.shape != (n, 64, 64, 3) or images.dtype != np.uint8:
    fail(f"bad images {images.shape} {images.dtype} for n={n}")
  flat = images.reshape(n, -1)
  if np.any(flat.max(axis=1) == flat.min(axis=1)):
    fail("a constant image came back")


def phase_serve_fused(build, card):
  """One 125-step sampler call at batch 64 under attn_impl="pallas_fused",
  through `build_sample_callable` (what the server calls)."""
  from small_vision_tpu_torch import convert
  from small_vision_tpu_torch.configs import ae_i1k
  from small_vision_tpu_torch.tools import export_sampler

  config = ae_i1k.get_config(f"variant=B/4,size=64,samples_per_call={BATCH},"
                             "attn_impl=pallas_fused")
  sample = export_sampler.build_sample_callable(
      config, convert.init_params(config, seed=0), fn="uncond_eps",
      batch_size=BATCH, device="cuda")
  sample(12345)  # warm-up call
  build.reset_launches()
  t0 = time.perf_counter()
  images = sample(1)  # returns numpy: ends in a device-to-host copy
  sampler_s = time.perf_counter() - t0
  launches = dict(build.LAUNCHES)
  print(f"[serve] pallas_fused: one sampler call {sampler_s:.3f} s = "
        f"{BATCH / sampler_s:.2f} img/s at batch {BATCH} on {card}",
        flush=True)
  _check_images(images, BATCH)
  want = _times(BLOCK_SAMPLE_LAUNCHES["pallas_fused"],
                BLOCKS * SAMPLER_FORWARDS)
  print(f"[serve] pallas_fused: kernel launches in the call: {launches}, "
        f"model says {want} and no other kernel", flush=True)
  if launches != want:  # no K3, K2, K4, K7, K8
    fail(f"launch counts {launches} != {want}")
  return {"launches": launches, "img_per_s": BATCH / sampler_s,
          "s": sampler_s}


def phase_unpacked(build, attn, card):
  """`fused_attention` on [B, L, H, D], which no module of the model calls:
  forward and backward through autograd at the decoder's training shape,
  against the plain versions on the CPU."""
  gen = torch.Generator().manual_seed(8)
  b, seq, head_dim = TRAIN_BATCH // 2, TRAIN_SEQS[-1], WIDTH // HEADS
  q, k, v, do = (torch.randn(b, seq, HEADS, head_dim, generator=gen)
                 .to(torch.bfloat16) for _ in range(4))
  results = {}
  for dev in ("cpu", "cuda"):
    args = [t.to(dev).clone().requires_grad_() for t in (q, k, v)]
    if dev == "cuda":
      build.reset_launches()
    out = attn.fused_attention(*args)
    out.backward(do.to(dev))
    if dev == "cuda":
      torch.cuda.synchronize()
      launches = dict(build.LAUNCHES)
    results[dev] = [out.detach().float().cpu()] + [a.grad.float().cpu()
                                                   for a in args]
  want = {attn.UNPACKED_NAME: 1, attn.UNPACKED_BWD_NAME: 1}
  worst = 0.0
  for c, g in zip(results["cpu"], results["cuda"]):
    # As in the kernels phase: a few bf16 ulps of the largest value.
    worst = max(worst, (c - g).abs().max().item() / c.abs().max().item())
  print(f"[unpacked] fused_attention ({b}, {seq}, {HEADS}, {head_dim}) "
        f"forward and backward: worst error {worst:.3e} of each tensor's "
        f"max against the CPU; launches {launches} on {card}", flush=True)
  if launches != want:
    fail(f"fused_attention launches {launches} != {want}")
  if not worst <= 2.0**-6:
    fail(f"fused_attention on the card differs from the CPU by {worst:.3e}")
  return launches


def phase_ablate(build, attn, card):
  """The ablation tool's `main` on the card: seven arms of K9 at two shapes,
  a warm-up and 20 timed launches each, and K3 beside them."""
  from small_vision_tpu_torch.tools import ablate_attention_kernel as tool

  build.reset_launches()
  results = tool.main([])
  launches = dict(build.LAUNCHES)
  per_timing = tool.N + 1
  want = {attn.ABLATE_NAME: len(attn.ABLATE_VARIANTS) * len(tool.SHAPES)
          * per_timing, attn.NAME: len(tool.SHAPES) * per_timing}
  print(f"[ablate] kernel launches of the tool: {launches}, expected {want} "
        f"on {card}", flush=True)
  if launches != want:
    fail(f"ablation tool launches {launches} != {want}")
  if not all(np.isfinite(t) and t > 0 for t in results.values()):
    fail(f"ablation tool times not positive and finite: {results}")
  return launches


def _stop_after_checkpoint(step):
  """A `log` callback that ends a run when step `step + 1` reports, as a
  crash would, once the checkpoint of step `step` has landed."""
  from small_vision_tpu_torch.utils import checkpoint as ckpt_lib

  class Stopped(Exception):
    pass

  def log(line):
    if line.startswith(f"step {step + 1}/"):
      for t in threading.enumerate():
        if t.name == ckpt_lib.WRITER_THREAD:
          t.join()
      raise Stopped
  return log, Stopped


def phase_resume(build, card, no_ckpt_img_per_s):
  """Checkpoint, evaluators and resume at full width; see the module's
  docstring."""
  from small_vision_tpu_torch.configs import ae_i1k
  from small_vision_tpu_torch.train import train_ae
  from small_vision_tpu_torch.utils import checkpoint as ckpt_lib
  from small_vision_tpu_torch.utils.chrono import Chrono

  steps, every = TRAIN_STEPS, 3

  def make_config():
    config = ae_i1k.get_config(
        f"variant=B/4,size=64,data=synthetic,batch_size={TRAIN_BATCH},"
        f"total_steps={steps},log_steps=1,ckpt_steps={every},"
        f"eval_steps={steps}")
    for ev in config["evals"].values():
      ev["num_batches"] = 2
    return config

  root = tempfile.mkdtemp(prefix="sv_resume_")
  try:
    dir_a, dir_b = os.path.join(root, "a"), os.path.join(root, "b")
    # A save that never completed: a directory that was not renamed.
    planted = os.path.join(dir_a, "checkpoints", "2.tmp")
    os.makedirs(planted)
    with open(os.path.join(planted, "params.npz"), "wb") as f:
      f.write(b"half-written")

    say = lambda tag: lambda s: print(f"[resume] {tag}: {s}", flush=True)
    build.reset_launches()
    state_a, hist_a = train_ae.train_and_evaluate(make_config(), dir_a,
                                                  device="cuda", log=say("A"))
    launches = dict(build.LAUNCHES)
    # 6 training steps, and 2 evaluators x 2 batches of one forward without
    # gradients each.
    want = _times(BLOCK_TRAIN_LAUNCHES["pallas"], 2 * BLOCKS * steps)
    for k, v in _times(BLOCK_SAMPLE_LAUNCHES["pallas"], BLOCKS * 4).items():
      want[k] += v
    if launches != want:
      fail(f"run A launches {launches} != {want}")
    left = sorted(os.listdir(os.path.join(dir_a, "checkpoints")))
    if left != [str(steps)]:
      fail(f"run A left checkpoints {left}, not the newest alone: the planted "
           "directory was not removed, or the rolling one was kept")
    # 1.7 GB each: keep the temporary directory small.
    shutil.rmtree(os.path.join(dir_a, "checkpoints"))

    stop_log, stopped = _stop_after_checkpoint(every)
    try:
      train_ae.train_and_evaluate(make_config(), dir_b, device="cuda",
                                  log=stop_log)
      fail("run B did not stop")
    except stopped:
      pass
    torch.cuda.empty_cache()
    notes = []

    def log_b(line):
      notes.append(line)
      say("B")(line)
    state_b, hist_b = train_ae.train_and_evaluate(make_config(), dir_b,
                                                  device="cuda", log=log_b)
    if not any(f"Resumed from step {every}" in n for n in notes):
      fail(f"run B did not resume from step {every}: {notes[:4]}")
    if [h["step"] for h in hist_b] != list(range(every + 1, steps + 1)):
      fail(f"run B ran steps {[h['step'] for h in hist_b]}")
    shutil.rmtree(dir_b)
    for what, a, b in (("params", state_a["params"], state_b["params"]),
                       ("mu", state_a["opt"]["mu"], state_b["opt"]["mu"]),
                       ("nu", state_a["opt"]["nu"], state_b["opt"]["nu"])):
      differing = sum(not torch.equal(x, y) for x, y in zip(a, b))
      if differing:
        fail(f"resume: {differing} of {len(a)} {what} tensors differ between "
             "the straight and the resumed run")
    print(f"[resume] step-{steps} parameters, mu and nu of the resumed run "
          f"equal the straight run's bit for bit ({len(state_a['params'])} "
          "tensors each)", flush=True)

    rows = [json.loads(l) for l in
            open(os.path.join(dir_a, "sv_tpu_metrics.txt"))]
    merged = {}
    for r in rows:
      merged.update(r)
    for key in ("training_loss", "z/img_per_sec", "val/loss",
                "mae_val/masked_mse"):
      values = [r[key] for r in rows if key in r]
      if not values or not all(np.isfinite(values)):
        fail(f"metrics file: {key} missing or not finite ({values})")
    if [r["step"] for r in rows] != list(range(1, steps + 1)):
      fail(f"metrics file rows {[r['step'] for r in rows]}")
    print(f"[resume] metrics at step {steps}: training_loss "
          f"{merged['training_loss']:.6f}, val/loss {merged['val/loss']:.6f}, "
          f"mae_val/masked_mse {merged['mae_val/masked_mse']:.6f}, "
          f"z/img_per_sec {merged['z/img_per_sec']:.2f}", flush=True)

    # One save, timed: the loop's part and the writer's.
    config = make_config()
    names = [n for n, _ in train_ae.named_params(
        train_ae.build_model(config, device="meta"))]
    ckpt = train_ae.checkpoint_state(state_a, names, Chrono(device="cuda"))
    n_bytes = sum(t.numel() * t.element_size() for entry in ckpt.values()
                  for t in entry.values() if isinstance(t, torch.Tensor))
    mngr = ckpt_lib.make_manager(os.path.join(root, "timing"))
    timing = []
    for i in (1, 2):  # the first save also pins its host buffers
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      ckpt_lib.save(mngr, ckpt, i)
      torch.cuda.synchronize()
      copied_s = time.perf_counter() - t0
      ckpt_lib.wait_until_finished(mngr)
      timing.append(dict(blocking_s=mngr.last_blocking_s, copied_s=copied_s,
                         write_s=mngr.last_write_s))
      print(f"[resume] save {i} of {n_bytes / 1e9:.3f} GB: the loop blocked "
            f"{mngr.last_blocking_s * 1e3:.1f} ms, the host copies done "
            f"after {copied_s * 1e3:.1f} ms, the background write "
            f"{mngr.last_write_s:.3f} s on {card}", flush=True)
    timed = hist_a[1:]
    ms = sum(h["ms"] for h in timed) / len(timed)
    print(f"[resume] run A, a checkpoint every {every} steps: "
          f"{TRAIN_BATCH / ms * 1e3:.2f} img/s by the steps' own clock "
          f"(the step after a save, {hist_a[every]['ms']:.2f} ms, waits for "
          f"its copies), {merged['z/img_per_sec']:.2f} by Chrono at step "
          f"{steps}; without checkpoints (phase train) "
          f"{no_ckpt_img_per_s:.2f} img/s on {card}", flush=True)
    return {"launches": launches, "save": timing,
            "img_per_s": TRAIN_BATCH / ms * 1e3}
  finally:
    shutil.rmtree(root, ignore_errors=True)


def phase_serve(build, card):
  """The main path: HTTP server, three requests, one 125-step call."""
  from small_vision_tpu_torch import convert
  from small_vision_tpu_torch.configs import ae_i1k
  from small_vision_tpu_torch.tools import export_sampler, serve
  from small_vision_tpu_torch.utils.trees import tree_flatten_with_names

  config = ae_i1k.get_config(f"variant=B/4,size=64,samples_per_call={BATCH}")
  t0 = time.perf_counter()
  params = convert.init_params(config, seed=0)
  sample = export_sampler.build_sample_callable(
      config, params, fn="uncond_eps", batch_size=BATCH, device="cuda")
  n_params = sum(a.size for _, a in tree_flatten_with_names(params))
  print(f"[serve] UMD-B/4@64, {n_params} parameters from seed 0, loaded in "
        f"{time.perf_counter() - t0:.2f} s", flush=True)
  t0 = time.perf_counter()
  sample(12345)  # warm-up call: cuBLAS handles, allocator, kernel loads
  print(f"[serve] warm-up sampler call {time.perf_counter() - t0:.2f} s",
        flush=True)

  server = serve.SamplerServer(sample, BATCH, max_wait_ms=2000.0)
  httpd = serve.make_http_server(server, 0, host="127.0.0.1")
  http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
  http_thread.start()
  url = f"http://127.0.0.1:{httpd.server_address[1]}/sample"
  sizes = (16, 16, 32)
  results, errors = [None] * len(sizes), []

  def request(i):
    try:
      body = json.dumps({"n": sizes[i]}).encode()
      req = urllib.request.Request(url, data=body, method="POST")
      with urllib.request.urlopen(req, timeout=600) as resp:
        results[i] = np.load(io.BytesIO(resp.read()))["images"]
    except Exception as e:  # noqa: BLE001 -- reported as the phase's failure
      errors.append(f"request {i}: {e!r}")

  try:
    build.reset_launches()
    t0 = time.perf_counter()
    clients = [threading.Thread(target=request, args=(i,))
               for i in range(len(sizes))]
    for c in clients:
      c.start()
    for c in clients:
      c.join(timeout=900)
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    stats = server.stats_snapshot()
  finally:
    httpd.shutdown()
    httpd.server_close()
    server.close(drain=False)

  if errors or any(c.is_alive() for c in clients):
    fail(f"requests did not complete: {errors}")
  sampler_s = stats["sampler_ms_last"] / 1e3
  print(f"[serve] pallas: {len(sizes)} requests {sizes} in {stats['batches']} "
        f"sampler call(s): {wall:.3f} s wall, sampler call {sampler_s:.3f} s "
        f"= {BATCH / sampler_s:.2f} img/s at batch {BATCH} on {card}",
        flush=True)
  if stats["batches"] != 1:
    fail(f"requests coalesced into {stats['batches']} calls, not 1")
  for n, images in zip(sizes, results):
    _check_images(images, n)
  want = _times(BLOCK_SAMPLE_LAUNCHES["pallas"], BLOCKS * SAMPLER_FORWARDS)
  print(f"[serve] pallas: kernel launches in the call: {launches}, model "
        f"says {want} and no other kernel", flush=True)
  if launches != want:  # no backward and no fused kernel
    fail(f"launch counts {launches} != {want}")
  return {"launches": launches, "img_per_s": BATCH / sampler_s,
          "s": sampler_s}


def main():
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; this script runs on the GPU only",
          file=sys.stderr)
    return 1
  from small_vision_tpu_torch.ops import _build as build
  from small_vision_tpu_torch.ops import attention as attn
  from small_vision_tpu_torch.ops import fused_block as fb
  from small_vision_tpu_torch.ops import layernorm as ln

  # f32 comparisons on the card stay in full f32.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  card = card_line()
  print(f"[device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; {card}", flush=True)

  phase_build(build)
  kernels = [check_ln(ln, card), check_attention(attn, card),
             check_ln_bwd(ln, card), check_attention_bwd(attn, card),
             check_fused_mlp(fb, card), check_fused_mha(fb, card),
             check_attention_unpacked(attn, card),
             check_attention_unpacked_bwd(attn, card),
             check_attention_ablate(attn, card)]
  for attn_impl in ATTN_IMPLS:
    phase_model(build, card, attn_impl)
  train = {a: phase_train(build, card, a) for a in ATTN_IMPLS}
  serve = {"pallas": phase_serve(build, card),
           "pallas_fused": phase_serve_fused(build, card)}
  unpacked = phase_unpacked(build, attn, card)
  ablate = phase_ablate(build, attn, card)
  resume = phase_resume(build, card, train["pallas"]["img_per_s"])
  for k in kernels:
    # Launches on the paths driven above, each counted from 0: the sampler
    # call and the training run under "pallas", the same two under
    # "pallas_fused", `fused_attention` for the two kernels that no module
    # of the model calls, the ablation tool, and run A of the resume phase
    # (6 training steps and the two evaluators). `launches` is the largest
    # of them: the count on the path that runs the kernel most.
    name = k["name"]
    k["launches_by_path"] = {
        **{f"serve_{a}": serve[a]["launches"].get(name, 0)
           for a in ATTN_IMPLS},
        **{f"train_{a}_{TRAIN_STEPS}_steps": train[a]["launches"].get(name, 0)
           for a in ATTN_IMPLS},
        "fused_attention": unpacked.get(name, 0),
        "ablate": ablate.get(name, 0),
        "resume": resume["launches"].get(name, 0)}
    k["launches"] = max(k["launches_by_path"].values())
    if not k["launches"]:
      fail(f"{name} was launched on no path")
  for a in ATTN_IMPLS:
    print(f"[result] {a}: training {train[a]['img_per_s']:.2f} img/s, "
          f"{train[a]['ms']:.2f} ms/step at batch {TRAIN_BATCH}; sampler "
          f"{serve[a]['img_per_s']:.2f} img/s, {serve[a]['s']:.3f} s a call "
          f"at batch {BATCH}; on {card}", flush=True)

  print(card, flush=True)
  print(json.dumps({"kernels": kernels}), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
