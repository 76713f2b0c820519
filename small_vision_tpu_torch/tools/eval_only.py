"""Evaluates the newest checkpoint of a workdir, without training.

Counterpart of small_vision_tpu/tools/eval_only.py: loads the config's
model and the newest checkpoint under `{workdir}/checkpoints` (the
trainer's `force_eval` path: it restores the train state and runs every
configured evaluator once, then returns) and repeats that `eval_repeats`
times. Metrics go to `{workdir}/sv_tpu_metrics.txt`; nothing else in the
workdir is written.

  python -m small_vision_tpu_torch.tools.eval_only \\
      --config eval_ae_i1k.py:variant=B/4,transfer=True,transfer_root=<t> \\
      --workdir /path/to/run
"""

import argparse


def run(config: dict, workdir: str, *, eval_repeats: int = 1,
        device="cuda", log=print):
  """Runs every evaluator of `config` on the newest checkpoint of
  `workdir`, `eval_repeats` times."""
  from small_vision_tpu_torch.train import train_ae
  config = dict(config, force_eval=True, save_ckpt=False)
  for _ in range(eval_repeats):
    train_ae.train_and_evaluate(config, workdir, device=device, log=log)


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument("--config", required=True)
  parser.add_argument("--workdir", required=True)
  parser.add_argument("--eval_repeats", type=int, default=1)
  parser.add_argument("--device", default="cuda")
  args = parser.parse_args(argv)

  from small_vision_tpu_torch.configs import parse_config
  run(parse_config(args.config), args.workdir,
      eval_repeats=args.eval_repeats, device=args.device)


if __name__ == "__main__":
  main()
