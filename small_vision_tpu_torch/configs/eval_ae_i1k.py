"""The eval-only config: FID of many samples and the transfer probes.

Counterpart of small_vision_tpu/configs/eval_ae_i1k.py, as a plain dict:
the training config of `ae_i1k.py` with `force_eval`, a run of 0 steps
(`total_steps = 0`, `total_epochs` removed: the duration units are
exclusive), no checkpoint written (`save_ckpt=False`), the sampler's
`sampling_timesteps`, `total_samples` on every sampling evaluator and,
with `transfer`, the few-shot probe on the reference's ten datasets
(`transfer`). `transfer_root` rewires every transfer dataset to
`arrays:{transfer_root}/{name}` with splits `train` and `validation`:
decoded arrays (stand-ins, or ingested with `tools/ingest_arrays.py`) in
place of the TFDS builds, which the port does not read.

  python -m small_vision_tpu_torch.tools.eval_only --config \\
      eval_ae_i1k.py:variant=B/4,transfer=True,transfer_root=/data/t,\\
      data=arrays:/data/i1k64 --workdir /path/to/run
"""

from small_vision_tpu_torch.configs import common as cc
from small_vision_tpu_torch.configs.ae_i1k import get_config as train_config
from small_vision_tpu_torch.configs.common_fewshot import get_fewshot_lsr

# The reference's transfer suite: {name: (train data, test data, train
# split, test split)}.
TRANSFER_DATASETS = {
    "imagenet": ("imagenet2012", "imagenet2012",
                 "train[:100000]", "validation"),
    "cifar100": ("cifar100", "cifar100", "train", "test"),
    "cifar10": ("cifar10", "cifar10", "train", "test"),
    "food101": ("food101", "food101", "train", "validation"),
    "pets": ("oxford_iiit_pet", "oxford_iiit_pet", "train", "test"),
    "flowers": ("oxford_flowers102", "oxford_flowers102", "train", "test"),
    "dtd": ("dtd", "dtd", "train", "test"),
    "cars": ("cars196", "cars196", "train", "test"),
    "caltech": ("caltech101", "caltech101", "train", "test"),
    "sun397": ("sun397", "sun397", "train", "validation"),
}


def get_config(arg=None) -> dict:
  arg = cc.parse_arg(
      arg, variant="B/4", batch_size=1024, size=64, adaln=True,
      use_labels=True, sampling_timesteps=125, total_samples=50_000,
      data="imagenet2012", transfer=False, latent_diffusion=False,
      transfer_root="", runlocal=False)

  base = ",".join(f"{k}={arg[k]}" for k in (
      "variant", "batch_size", "size", "adaln", "use_labels", "data",
      "latent_diffusion", "runlocal"))
  config = train_config(base)
  config["force_eval"] = True
  config.pop("total_epochs", None)
  config["total_steps"] = 0
  config["save_ckpt"] = False
  config["diff_schedule"]["sampling_timesteps"] = arg["sampling_timesteps"]

  for name, ev in config["evals"].items():
    if name.startswith("sample"):
      ev["total_samples"] = arg["total_samples"]

  if arg["transfer"]:
    datasets = dict(TRANSFER_DATASETS)
    if arg["transfer_root"]:
      root = arg["transfer_root"]
      datasets = {name: (f"arrays:{root}/{name}", f"arrays:{root}/{name}",
                         "train", "validation")
                  for name in TRANSFER_DATASETS}
    config["evals"]["transfer"] = get_fewshot_lsr(
        target_resolution=arg["size"],
        resize_resolution=int(arg["size"] * 256 / 246),
        runlocal=arg["runlocal"], datasets=datasets,
        pred="predict" if config["no_noise_prob"] > 0 else "noised_predict")
    if arg["runlocal"]:  # the stand-ins' size: 2-shot probes
      config["evals"]["transfer"]["shots"] = (2,)
  return config
