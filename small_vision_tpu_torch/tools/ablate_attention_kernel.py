"""Where the packed attention kernel's time goes, on the GPU.

  python -m small_vision_tpu_torch.tools.ablate_attention_kernel
      [--variants prod,nosoftmax,...] [--device cuda]

Counterpart of scripts/ablate_attention_kernel.py: times the seven arms of
the ablation kernel (K9, `ops.attention.attention_ablate`) at the two shapes
of the UMD-B/4 training step, (128, 257, 768) and (128, 164, 768) bf16 with
12 heads of 64:
  prod       the max-shift softmax, probabilities rounded before p·V
  nosoftmax  softmax replaced by a scalar multiply (the two products alone)
  nomm       no QK product, no p·V (the softmax alone)
  bf16exp    exp of scores rounded to bf16
  exp2       exp2 with log2(e) folded into the scores
  mulmask    keys masked by a multiply after exp, not by -inf before the max
  nomax      no row max (numerically unsafe; the cost of the max pass)
One line per arm: the mean of N = 20 launches between two CUDA events after
a warm-up launch, and the TFLOP/s that time would mean for the full
attention's 2·2·H·L·L·D·B operations, beside the card's name and power
limit. Once per shape it also prints the model's own attention kernel
(`attention_packed_fwd`) and `scaled_dot_product_attention`, which the arms
are yardsticks for. Inputs come from a `torch.Generator` seeded 0.
"""

import argparse

import torch

from small_vision_tpu_torch.ops import attention as attn
from small_vision_tpu_torch.tools.profile_sampler import card_line

N = 20
SHAPES = ((128, 257, 12, 64), (128, 164, 12, 64))  # (B, L, H, D)


def dev_time(fn, n=N) -> float:
  """Mean seconds of one call of `fn` over `n` calls, by CUDA events, after
  one warm-up call."""
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(n):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / 1e3 / n


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument("--variants", default=",".join(attn.ABLATE_VARIANTS),
                      help="comma-separated arms, of "
                           + ", ".join(attn.ABLATE_VARIANTS))
  parser.add_argument("--device", default="cuda")
  args = parser.parse_args(argv)
  variants = [v for v in args.variants.split(",") if v]
  unknown = sorted(set(variants) - set(attn.ABLATE_VARIANTS))
  if unknown:
    raise SystemExit(f"unknown variants {unknown}; the arms are "
                     f"{attn.ABLATE_VARIANTS}")
  device = torch.device(args.device)
  if device.type != "cuda":
    raise SystemExit("ablate_attention_kernel times kernels on the GPU; "
                     "`attention_ablate` on CPU tensors runs the plain "
                     "version, which has no time worth reading")
  if not torch.cuda.is_available():
    raise SystemExit("ablate_attention_kernel: no CUDA device")

  card = card_line()
  results = {}
  for (b, l, h, d) in SHAPES:
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn(b, l, h * d, generator=gen, device=device)
               .to(torch.bfloat16) for _ in range(3))
    flops = 2 * 2 * h * l * l * d * b
    line = lambda name, t: print(
        f"B{b} L{l}: {name:10s} {t * 1e3:6.3f} ms "
        f"({flops / t / 1e12:5.1f} TF/s-equiv) on {card}", flush=True)
    for variant in variants:
      t = dev_time(lambda: attn.attention_ablate(q, k, v, h, variant))
      results[(b, l, variant)] = t
      line(variant, t)
    split = lambda x: x.view(b, l, h, d).transpose(1, 2)
    results[(b, l, "packed")] = dev_time(
        lambda: attn.attention_packed_fwd(q, k, v, h))
    line("packed(K3)", results[(b, l, "packed")])
    results[(b, l, "sdpa")] = dev_time(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            split(q), split(k), split(v)))
    line("sdpa", results[(b, l, "sdpa")])
  return results


if __name__ == "__main__":
  main()
