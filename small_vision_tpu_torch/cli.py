"""Command-line entry point of the port's trainer.

Counterpart of small_vision_tpu/cli.py: `--main ae` trains UMD
(`train/train_ae.py`), `--main lp_ae` the linear probe on a frozen UMD
(`train/linear_ae.py`, with `configs/ae_i1k_lp.py`):

  python -m small_vision_tpu_torch.cli \\
      --config ae_i1k.py:data=synthetic,batch_size=256,total_steps=20 \\
      --workdir /tmp/run
  python -m small_vision_tpu_torch.cli --main lp_ae \\
      --config ae_i1k_lp.py:pretrain_workdir=/tmp/run --workdir /tmp/probe

(`attn_impl=pallas_fused` in the config string trains with the fused MLP
and MHA kernels.) With `--workdir` the run writes its metrics
(`sv_tpu_metrics.txt`), its config, checkpoints every `ckpt_steps` and the
evaluators' outputs there, and a second start on the same workdir resumes
from the newest checkpoint. `--cleanup` deletes the workdir after a
successful run. The JAX CLI's `--jax_cache` and `--transfer_guard` have no
counterpart.
Trains on the GPU unless `--device cpu` is given; there is no fallback to
the CPU when no GPU is present.

Under a launcher (`srun`, `mpirun`: `launch.py`) the CLI joins the process
group its environment describes (`parallel.mesh.init_distributed`; NCCL on
the cards, gloo with `--device cpu`) and trains on `cuda:<local rank>`; the
trainer builds its mesh from the config (`fsdp=True`: every process on the
`fsdp` axis).
"""

import argparse
import os
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

  device = args.device
  if torch.device(device).type == "cuda":
    if not torch.cuda.is_available():
      raise SystemExit("no CUDA device; pass --device cpu to train on the "
                       "CPU with the plain versions of the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
  from small_vision_tpu_torch.parallel import mesh as mesh_lib
  mesh_lib.init_distributed(device=device)
  if mesh_lib.process_count() > 1 and device == "cuda":
    device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    torch.cuda.set_device(torch.device(device))
  if args.main == "ae":
    from small_vision_tpu_torch.train import train_ae as trainer
  else:
    from small_vision_tpu_torch.train import linear_ae as trainer
  config = parse_config(args.config)
  _, history = trainer.train_and_evaluate(config, args.workdir,
                                          device=device)
  timed = history[1:] or history
  if timed and mesh_lib.process_index() == 0:
    # (history is empty after `force_eval`, or when the run was done)
    ms = sum(h["ms"] for h in timed) / len(timed)
    batch = int(config["input"]["batch_size"])
    peak = (f", peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
            if torch.device(device).type == "cuda" else "")
    print(f"mean step {ms:.2f} ms after the first, "
          f"{batch / ms * 1e3:.2f} img/s at batch {batch} on {device} "
          f"({mesh_lib.process_count()} process(es)){peak}", flush=True)
  if args.cleanup and args.workdir and mesh_lib.process_index() == 0:
    shutil.rmtree(args.workdir, ignore_errors=True)


if __name__ == "__main__":
  main()
