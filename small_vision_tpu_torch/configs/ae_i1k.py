"""The UMD config on ImageNet-1k, as a plain dict.

Counterpart of small_vision_tpu/configs/ae_i1k.py, for the fields the port
runs: the model, the diffusion schedule, the sampler's samples per call and
labels, and the training step (batch size, mask ratios, the MAE/diffusion
split, AdamW, the schedule's durations, EMA, the input with its pp string,
`fused_branches`), the checkpoint cadence, the model's `quant`, and the
evaluator entries `val`, `mae_val`, the few-shot probe `fewshot` (every
10,000 steps, on the first 100,000 training examples and the validation
split) and, with labels, the three sampling evaluators with their FID
inputs (`fid_stats`: the reference statistics' .npz, which
`evaluators/fid.py::compute_reference_stats` writes; `inception_weights`:
InceptionV3's .npz, from `scripts/convert_inception.py`; unset, the
samples are saved unscored).

`data` is `synthetic` (the default here, as no dataset is in the
repository), `arrays:<root>` (decoded uint8 images in memmaps, a parent of
`train/` and `validation/`, as `tools/ingest_arrays.py` writes them), or a
dataset name such as `imagenet2012`, whose training pp is the JAX config's
`decode_jpeg_and_inception_crop(size, area_min)` and whose source (TFDS)
raises in the port, naming the arrays route.

  --config ae_i1k.py:variant=B/4,size=64
  --config ae_i1k.py:use_labels=True          # class-conditional, CFG, EMA
  --config ae_i1k.py:batch_size=256,total_steps=20
  --config ae_i1k.py:runlocal                 # width 64, depth 2: CPU tests
  --config ae_i1k.py:attn_impl=pallas_fused   # fused MLP and MHA kernels
  --config ae_i1k.py:attn_impl=xla            # the reference attentions:
  --config ae_i1k.py:attn_impl=flax           #   matmuls and a softmax
  --config ae_i1k.py:heads=6                  # 6 heads of 128 at width 768
  --config ae_i1k.py:scan=True                # stacked blocks, remat
  --config ae_i1k.py:variant=S/4              # UMD-S: width 384, 6 heads
  --config ae_i1k.py:ckpt_steps=500,eval_steps=1000   # with --workdir
  --config ae_i1k.py:eval_steps=-1            # no evaluators
  --config ae_i1k.py:data=arrays:/data/i1k64  # train/ and validation/
  --config ae_i1k.py:quant=int8_mlp           # int8 MLP products
  --config ae_i1k.py:use_labels=True,fid_stats=ref.npz,inception_weights=inc.npz
  --config ae_i1k.py:variant=L/2,size=256,latent_diffusion=True
                      # UMD-L/2 on SD-VAE latents (seeded VAE unless
                      # vae_weights=<npz of scripts/convert_vae.py>)

`scan=True` holds the blocks in the stacked layout of flax's `nn.scan` and
rematerialises each under `model.remat_policy` ("nothing_saveable", as in
the JAX config: a step keeps the blocks' inputs only). `fsdp=True` is the
JAX config's: `fully_sharded` parameters and optimizer state, every
process on the `fsdp` axis (`mesh_fsdp=0`), `scan=True`; one process
trains as without it.

With `latent_diffusion` (size 256 only) the model works on (32, 32, 4)
latents of the Stable Diffusion VAE: `diffusion_space` (32, 32, 4), the
model's `channels` 4 and `img_size` 32, the linear beta schedule without
clipping the denoised prediction; the training step encodes the pixels
unless `use_preprocessed_latents` says the batches carry latents.
"""

from small_vision_tpu_torch.configs import common as cc
from small_vision_tpu_torch.configs.common_fewshot import get_fewshot_lsr


def get_config(arg=None) -> dict:
  arg = cc.parse_arg(
      arg, variant="B/4", scan=False, fsdp=False, heads=0, size=64,
      use_labels=False, adaln=True,
      samples_per_call=0, runlocal=False, batch_size=1024, mask_ratio=0.375,
      no_noise_prob=0.5, mask_ratio_no_noise=0.75, lr=15e-5, wd=5e-2,
      beta2=0.95, epochs=800, data="synthetic", area_min=80, total_steps=0,
      log_steps=0,
      fused_branches=False, attn_impl="pallas", finetune=False,
      save_ckpt=True,
      ckpt_steps=0,  # 0 = keep the default (5000; runlocal 8)
      keep_ckpt_steps=0,  # > 0: checkpoints at its multiples stay for ever
      eval_steps=0,  # 0 = per-evaluator defaults (25k loss / 10k fewshot),
      # -1 = no evaluators
      quant="",  # "" (bf16) | "int8_mlp" | "int8_all": ops/quant.py
      fid_stats="", inception_weights="",  # FID inputs (.npz); "" = unscored
      fid_batch=0,  # 0 = 1024 images an InceptionV3 batch
      total_samples=0,  # 0 = 10k samples per sampling evaluator
      # The latent path (size 256 only): the model diffuses SD-VAE latents
      # (32, 32, 4), encoded inside the training step from the pixels, or
      # fed in by the caller with use_preprocessed_latents.
      latent_diffusion=False, use_preprocessed_latents=False,
      vae_weights="")  # the npz of scripts/convert_vae.py; "" = seeded

  latent = arg["latent_diffusion"]
  if latent:
    assert arg["size"] == 256, "Latent diffusion only supports 256x256 images"
  config = {
      "size": arg["size"],
      "latent_diffusion": latent,
      "diffusion_space": (32, 32, 4) if latent else (arg["size"],
                                                     arg["size"], 3),
      "resize": int(arg["size"] * (256 / 246)),
      "seed": 0,
      "use_labels": arg["use_labels"],
      "num_classes": 1000 if arg["use_labels"] else None,
      "num_samples": 36,
      "num_samples_per_call": arg["samples_per_call"] or 1024,
      "fid_batch_size": arg["fid_batch"] or 1024,
      "diff_schedule": dict(eta=1.0,
                            beta_schedule="linear" if latent else "cosine",
                            clip_denoised=not latent, timesteps=1000,
                            sampling_timesteps=125),
      "model_name": "ae",
      # Training.
      "batch_size": arg["batch_size"],
      "no_noise_prob": arg["no_noise_prob"],
      "mask_ratio": arg["mask_ratio"],
      "mask_ratio_no_noise": arg["mask_ratio_no_noise"],
      "fused_branches": arg["fused_branches"],
      "optax_name": "adamw",
      "clip_norm": 1.0,
      "peak_lr": arg["lr"],
      "wd": arg["wd"],
      "betas": (0.9, arg["beta2"]),
      "log_training_steps": arg["log_steps"] or 100,
      "ckpt_steps": arg["ckpt_steps"] or 5000,
      "save_ckpt": arg["save_ckpt"],
      "finetune": arg["finetune"],
  }
  if latent:
    config["use_preprocessed_latents"] = arg["use_preprocessed_latents"]
    if arg["vae_weights"]:
      config["vae_weights"] = arg["vae_weights"]
  if arg["keep_ckpt_steps"]:
    config["keep_ckpt_steps"] = arg["keep_ckpt_steps"]
  if arg["total_steps"]:
    config["total_steps"] = arg["total_steps"]
  else:
    config["total_epochs"] = arg["epochs"]
    config["warmup_epochs"] = int(0.05 * arg["epochs"])
  if arg["use_labels"]:
    config["ema_decay"] = 0.0001 * (arg["batch_size"] / 256)
  data = arg["data"]
  decoded = data == "synthetic" or data.startswith("arrays:")
  if data == "synthetic":
    data_cfg = dict(name="synthetic", img_size=arg["size"],
                    num_examples=50_000)
    eval_data = dict(data_cfg, split="validation")
  else:
    data_cfg = (dict(name="arrays", root=data[len("arrays:"):])
                if decoded else dict(name=data, split="train[:99%]"))
    eval_data = dict(name=data, split="validation")
  pp_train = "|flip_lr" if decoded else (
      f"decode_jpeg_and_inception_crop(size={arg['size']}, "
      f"area_min={arg['area_min']})|flip_lr")
  pp_common = '|value_range(-1, 1)|keep("image", "label")'
  config["input"] = {
      "data": data_cfg,
      "pp": pp_train + pp_common,
      "batch_size": arg["batch_size"],
      "num_workers": 16,
      "prefetch_to_device": 4,
  }

  # Evaluators, on the source's validation split. Synthetic and arrays
  # images are decoded and of the right size: their eval pp is the device
  # stage alone.
  pp_eval = pp_common[1:] if decoded else (
      f"decode|resize_small({arg['size']})|central_crop({arg['size']})"
      + pp_common)

  def get_eval(eval_type, pred):
    return dict(type=eval_type, data=dict(eval_data), pp_fn=pp_eval,
                log_steps=25_000, pred=pred, cache_final=True)

  def get_sample_eval(pred):
    return dict(type="diffusion_sampling", pred=pred,
                total_samples=arg["total_samples"] or 10_000,
                log_steps=25_000)

  evals = {}
  if arg["no_noise_prob"] < 1.0:
    evals["val"] = get_eval("diffusion_loss", "loss")
  if arg["mask_ratio"] > 0.0 or arg["no_noise_prob"] > 0.0:
    evals["mae_val"] = get_eval("mae_reconstruction", "patch")
  evals["fewshot"] = get_fewshot_lsr(
      target_resolution=arg["size"], resize_resolution=config["resize"],
      datasets={"imagenet": (data, data, "train[:100000]", "validation")},
      pred="predict" if arg["no_noise_prob"] > 0.0 else "noised_predict")
  evals["fewshot"]["log_steps"] = 10_000
  if arg["no_noise_prob"] < 1.0 and arg["use_labels"]:
    evals["sample_cond"] = get_sample_eval("cond_eps")
    evals["sample_cfg_1_5"] = get_sample_eval("cfg_eps_2.0")
    evals["sample_cfg_4"] = get_sample_eval("cfg_eps_4.0")
    config["inception_reference_path"] = arg["fid_stats"]
    config["inception_weights"] = arg["inception_weights"]
  if arg["eval_steps"] < 0:  # -1 = no evaluators (pure-throughput runs).
    evals = {}
  elif arg["eval_steps"]:  # One knob over every evaluator's cadence.
    for ev in evals.values():
      ev["log_steps"] = arg["eval_steps"]
  config["evals"] = evals

  model = dict(
      num_classes=config["num_classes"], variant=arg["variant"],
      scan=arg["scan"], adaln=arg["adaln"],
      channels=config["diffusion_space"][-1],
      img_size=config["diffusion_space"][0],
      remat_policy="nothing_saveable", dtype_mm="bfloat16",
      attn_impl=arg["attn_impl"])
  if arg["quant"]:
    model["quant"] = arg["quant"]
  if arg["heads"]:  # heads=6 at width 768: head dim 128
    model["num_heads"] = arg["heads"]
  if arg["fsdp"]:
    config["param_sharding"] = "fully_sharded"
    config["optim_sharding"] = "fully_sharded"
    config["mesh_fsdp"] = 0  # 0: every process on the fsdp axis
    model["scan"] = True
  if arg["runlocal"]:
    model.update(width=64, depth=2, dec_depth=1, num_heads=4, scan=False)
    config["input"]["batch_size"] = config["batch_size"] = 32
    config["input"]["num_workers"] = 2
    if data == "synthetic":
      config["input"]["data"]["num_examples"] = 512
    config["log_training_steps"] = arg["log_steps"] or 4
    config["ckpt_steps"] = arg["ckpt_steps"] or 8
    config["evals"] = {}
  config["model"] = model
  return config
