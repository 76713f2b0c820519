"""Smoke run of the PyTorch/CUDA port (small_vision_tpu_torch) on one GPU.

  python3 chip_smoke.py

Phases, each fatal on failure:
  1. build     nvcc builds every kernel under small_vision_tpu_torch/csrc/.
  2. kernels   each kernel against its plain PyTorch version on the card, at
               the shapes of the UMD-B/4@64 sampler at batch 64, with its
               time, the plain version's, one library call's and the bound.
  3. model     the model forward at full width (depth cut to 2 + 1) on the
               card (kernels) against the CPU (plain versions), same weights
               and inputs.
  4. serve     the port's HTTP sampling server at full UMD-B/4@64 size from
               seeded random weights: three concurrent requests (16, 16, 32
               images) coalesce into one 125-step DDIM call of batch 64; the
               kernel launch counts of that call must be what the model says.
Then it prints the card's name and power limit, one JSON line of the
kernels, and as its last line {"ok": true, "device": {...}}. Without a CUDA
device it exits non-zero and prints no result.
"""

import io
import json
import subprocess
import sys
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
  bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
  ops_ms = 9 * n / F32_FLOPS * 1e3
  print(f"[kernels] ln_modulate_fwd B={BATCH} L={SEQ_ENC} D={WIDTH} "
        f"modulated: kernel {timing['ms']:.4f} ms, plain "
        f"{timing['plain_ms']:.4f} ms, layer_norm+modulate "
        f"{timing['library_ms']:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} "
        f"ms ({bytes_moved} bytes) on {card}", flush=True)
  return dict(name=ln.NAME, route="cuda",
              source="small_vision_tpu_torch/csrc/ln_modulate.cu",
              replaces="small_vision_tpu/ops/layernorm.py:58",
              max_abs_err=max_err, bound_ms=max(bytes_ms, ops_ms),
              bound_by="bytes" if bytes_ms >= ops_ms else "operations",
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
  bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
  ops_ms = flops / BF16_FLOPS * 1e3
  print(f"[kernels] attention_packed_fwd B={BATCH} L={SEQ_ENC} H={HEADS} "
        f"D={head_dim}: kernel {timing['ms']:.4f} ms, plain "
        f"{timing['plain_ms']:.4f} ms, sdpa {timing['library_ms']:.4f} ms, "
        f"bound {max(bytes_ms, ops_ms):.4f} ms ({bytes_moved} bytes, "
        f"{flops} flops) on {card}", flush=True)
  return dict(name=attn.NAME, route="cuda",
              source="small_vision_tpu_torch/csrc/attention_packed.cu",
              replaces="small_vision_tpu/ops/attention.py:258",
              max_abs_err=max_err, bound_ms=max(bytes_ms, ops_ms),
              bound_by="bytes" if bytes_ms >= ops_ms else "operations",
              **timing)


def phase_model():
  """Full-width model at depth 2 + 1: card (kernels) against CPU (plain)."""
  from small_vision_tpu_torch import convert
  from small_vision_tpu_torch.configs import ae_i1k
  from small_vision_tpu_torch.train import train_ae

  config = ae_i1k.get_config()
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
  print(f"[model] forward (3, 64, 64, 3) at width {WIDTH}, depth 2+1, "
        f"t = {t.tolist()}: max abs err {err:.3e} of max |pred| "
        f"{scale:.3e}", flush=True)
  # bf16 matmuls summed in another order on the two devices: a few bf16
  # roundings (2^-8 relative each) through three blocks and the head.
  if not err <= 3e-2 * scale:
    fail(f"model forward on the card differs from the CPU by {err:.3e}")


def phase_serve(build, ln, attn, card):
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
    launches = {name: build.LAUNCHES[name] for name in (ln.NAME, attn.NAME)}
    stats = server.stats_snapshot()
  finally:
    httpd.shutdown()
    httpd.server_close()
    server.close(drain=False)

  if errors or any(c.is_alive() for c in clients):
    fail(f"requests did not complete: {errors}")
  sampler_s = stats["sampler_ms_last"] / 1e3
  print(f"[serve] {len(sizes)} requests {sizes} in {stats['batches']} "
        f"sampler call(s): {wall:.3f} s wall, sampler call {sampler_s:.3f} s "
        f"= {BATCH / sampler_s:.2f} img/s at batch {BATCH} on {card}",
        flush=True)
  if stats["batches"] != 1:
    fail(f"requests coalesced into {stats['batches']} calls, not 1")
  for n, images in zip(sizes, results):
    if images.shape != (n, 64, 64, 3) or images.dtype != np.uint8:
      fail(f"bad images {images.shape} {images.dtype} for n={n}")
    flat = images.reshape(n, -1)
    if np.any(flat.max(axis=1) == flat.min(axis=1)):
      fail("a constant image came back")
  want = {ln.NAME: 2 * BLOCKS * SAMPLER_FORWARDS,
          attn.NAME: BLOCKS * SAMPLER_FORWARDS}
  print(f"[serve] kernel launches in the call: {launches}, model says "
        f"{want}", flush=True)
  if launches != want:
    fail(f"launch counts {launches} != {want}")
  return launches


def main():
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; this script runs on the GPU only",
          file=sys.stderr)
    return 1
  from small_vision_tpu_torch.ops import _build as build
  from small_vision_tpu_torch.ops import attention as attn
  from small_vision_tpu_torch.ops import layernorm as ln

  # f32 comparisons on the card stay in full f32.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  card = card_line()
  print(f"[device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; {card}", flush=True)

  phase_build(build)
  kernels = [check_ln(ln, card), check_attention(attn, card)]
  phase_model()
  launches = phase_serve(build, ln, attn, card)
  for k in kernels:
    k["launches"] = launches[k["name"]]

  print(card, flush=True)
  print(json.dumps({"kernels": kernels}), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
