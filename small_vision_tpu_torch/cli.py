"""Command-line entry point of the port's trainer.

Counterpart of small_vision_tpu/cli.py (`--main ae` only; the linear probe
comes with its slice):

  python -m small_vision_tpu_torch.cli \\
      --config ae_i1k.py:data=synthetic,batch_size=256,total_steps=20 \\
      --workdir /tmp/run

(`attn_impl=pallas_fused` in the config string trains with the fused MLP
and MHA kernels.) With `--workdir` the run writes its metrics
(`sv_tpu_metrics.txt`), its config, checkpoints every `ckpt_steps` and the
evaluators' outputs there, and a second start on the same workdir resumes
from the newest checkpoint. `--cleanup` deletes the workdir after a
successful run. The JAX CLI's `--jax_cache` and `--transfer_guard` have no
counterpart.
Trains on the GPU unless `--device cpu` is given; there is no fallback to
the CPU when no GPU is present.
"""

import argparse
import shutil

import torch

from small_vision_tpu_torch.configs import parse_config


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument("--config", required=True,
                      help="config file spec: name.py:arg,arg=val")
  parser.add_argument("--workdir", default=None)
  parser.add_argument("--main", default="ae", choices=["ae", "lp_ae"])
  parser.add_argument("--device", default="cuda")
  parser.add_argument("--cleanup", action="store_true",
                      help="delete the workdir after a successful run")
  args = parser.parse_args(argv)

  if torch.device(args.device).type == "cuda":
    if not torch.cuda.is_available():
      raise SystemExit("no CUDA device; pass --device cpu to train on the "
                       "CPU with the plain versions of the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
  if args.main != "ae":
    raise SystemExit("--main lp_ae: the linear probe comes with its slice")
  from small_vision_tpu_torch.train import train_ae
  config = parse_config(args.config)
  _, history = train_ae.train_and_evaluate(config, args.workdir,
                                           device=args.device)
  timed = history[1:] or history
  if timed:  # empty after `force_eval`, or when the run was already done
    ms = sum(h["ms"] for h in timed) / len(timed)
    batch = int(config["input"]["batch_size"])
    print(f"mean step {ms:.2f} ms after the first, "
          f"{batch / ms * 1e3:.2f} img/s at batch {batch} on {args.device}",
          flush=True)
  if args.cleanup and args.workdir:
    shutil.rmtree(args.workdir, ignore_errors=True)


if __name__ == "__main__":
  main()
