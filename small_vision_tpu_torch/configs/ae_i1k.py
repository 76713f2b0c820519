"""The UMD config on ImageNet-1k, sampler fields only, as a plain dict.

Counterpart of small_vision_tpu/configs/ae_i1k.py. This slice of the port
serves the DDIM sampler, so only the fields the sampler reads are kept: the
model, the diffusion schedule, the samples per call and the labels. The
training, data and evaluator fields come with their slices.

  --config ae_i1k.py:variant=B/4,size=64
  --config ae_i1k.py:use_labels=True          # class-conditional, CFG fns
  --config ae_i1k.py:runlocal                 # width 64, depth 2: CPU tests
"""

from small_vision_tpu_torch.configs import common as cc


def get_config(arg=None) -> dict:
  arg = cc.parse_arg(
      arg, variant="B/4", size=64, use_labels=False, adaln=True,
      samples_per_call=0, runlocal=False)

  config = {
      "diffusion_space": (arg["size"], arg["size"], 3),
      "use_labels": arg["use_labels"],
      "num_classes": 1000 if arg["use_labels"] else None,
      "num_samples": 36,
      "num_samples_per_call": arg["samples_per_call"] or 1024,
      "diff_schedule": dict(eta=1.0, beta_schedule="cosine",
                            clip_denoised=True, timesteps=1000,
                            sampling_timesteps=125),
      "model_name": "ae",
  }
  model = dict(
      num_classes=config["num_classes"], variant=arg["variant"],
      adaln=arg["adaln"], channels=3, img_size=arg["size"],
      dtype_mm="bfloat16")
  if arg["runlocal"]:
    model.update(width=64, depth=2, dec_depth=1, num_heads=4)
  config["model"] = model
  return config
