"""Command-line entry point of the port's trainer.

Counterpart of small_vision_tpu/cli.py (`--main ae` only; the linear probe
comes with its slice):

  python -m small_vision_tpu_torch.cli \\
      --config ae_i1k.py:data=synthetic,batch_size=256,total_steps=20

(`attn_impl=pallas_fused` in the config string trains with the fused MLP
and MHA kernels.)
Trains on the GPU unless `--device cpu` is given; there is no fallback to
the CPU when no GPU is present.
"""

import argparse

import torch

from small_vision_tpu_torch.configs import parse_config


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument("--config", required=True,
                      help="config file spec: name.py:arg,arg=val")
  parser.add_argument("--workdir", default=None)
  parser.add_argument("--device", default="cuda")
  args = parser.parse_args(argv)

  if torch.device(args.device).type == "cuda":
    if not torch.cuda.is_available():
      raise SystemExit("no CUDA device; pass --device cpu to train on the "
                       "CPU with the plain versions of the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
  from small_vision_tpu_torch.train import train_ae
  config = parse_config(args.config)
  _, history = train_ae.train_and_evaluate(config, args.workdir,
                                           device=args.device)
  timed = history[1:] or history
  ms = sum(h["ms"] for h in timed) / len(timed)
  batch = int(config["input"]["batch_size"])
  print(f"mean step {ms:.2f} ms after the first, "
        f"{batch / ms * 1e3:.2f} img/s at batch {batch} on {args.device}",
        flush=True)


if __name__ == "__main__":
  main()
