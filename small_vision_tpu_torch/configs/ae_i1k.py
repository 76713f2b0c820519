"""The UMD config on ImageNet-1k, as a plain dict.

Counterpart of small_vision_tpu/configs/ae_i1k.py, for the fields the port
runs: the model, the diffusion schedule, the sampler's samples per call and
labels, and the training step (batch size, mask ratios, the MAE/diffusion
split, AdamW, the schedule's durations, EMA, the input with its pp string,
`fused_branches`), the checkpoint cadence and the evaluator entries `val`,
`mae_val` and, with labels, the three sampling evaluators. The few-shot
probe's entry waits for the evaluators slice and the ImageNet input for the
data slice; `data` is `synthetic` (the default here, as no dataset is in the
repository).

  --config ae_i1k.py:variant=B/4,size=64
  --config ae_i1k.py:use_labels=True          # class-conditional, CFG, EMA
  --config ae_i1k.py:batch_size=256,total_steps=20
  --config ae_i1k.py:runlocal                 # width 64, depth 2: CPU tests
  --config ae_i1k.py:attn_impl=pallas_fused   # fused MLP and MHA kernels
  --config ae_i1k.py:ckpt_steps=500,eval_steps=1000   # with --workdir
  --config ae_i1k.py:eval_steps=-1            # no evaluators
"""

from small_vision_tpu_torch.configs import common as cc


def get_config(arg=None) -> dict:
  arg = cc.parse_arg(
      arg, variant="B/4", size=64, use_labels=False, adaln=True,
      samples_per_call=0, runlocal=False, batch_size=1024, mask_ratio=0.375,
      no_noise_prob=0.5, mask_ratio_no_noise=0.75, lr=15e-5, wd=5e-2,
      beta2=0.95, epochs=800, data="synthetic", total_steps=0, log_steps=0,
      fused_branches=False, attn_impl="pallas", finetune=False,
      save_ckpt=True,
      ckpt_steps=0,  # 0 = keep the default (5000; runlocal 8)
      keep_ckpt_steps=0,  # > 0: checkpoints at its multiples stay for ever
      eval_steps=0,  # 0 = per-evaluator defaults (25k), -1 = no evaluators
      total_samples=0)  # 0 = 10k samples per sampling evaluator
  if arg["data"] != "synthetic":
    raise ValueError(f"data={arg['data']!r}: the port has the synthetic "
                     "source only (ImageNet comes with the data slice)")

  config = {
      "diffusion_space": (arg["size"], arg["size"], 3),
      "seed": 0,
      "use_labels": arg["use_labels"],
      "num_classes": 1000 if arg["use_labels"] else None,
      "num_samples": 36,
      "num_samples_per_call": arg["samples_per_call"] or 1024,
      "diff_schedule": dict(eta=1.0, beta_schedule="cosine",
                            clip_denoised=True, timesteps=1000,
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
  if arg["keep_ckpt_steps"]:
    config["keep_ckpt_steps"] = arg["keep_ckpt_steps"]
  if arg["total_steps"]:
    config["total_steps"] = arg["total_steps"]
  else:
    config["total_epochs"] = arg["epochs"]
    config["warmup_epochs"] = int(0.05 * arg["epochs"])
  if arg["use_labels"]:
    config["ema_decay"] = 0.0001 * (arg["batch_size"] / 256)
  config["input"] = {
      "data": dict(name="synthetic", img_size=arg["size"],
                   num_examples=50_000),
      "pp": '|flip_lr|value_range(-1, 1)|keep("image", "label")',
      "batch_size": arg["batch_size"],
  }

  # Evaluators, on the source's validation split. The synthetic source's
  # images are decoded and of the right size: the eval pp is the device
  # stage alone.
  pp_eval = 'value_range(-1, 1)|keep("image", "label")'
  eval_data = dict(config["input"]["data"], split="validation")

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
  # The JAX config's `fewshot` entry (evaluators/fewshot_lsr.py) is left out
  # until the evaluators slice ports the probe.
  if arg["no_noise_prob"] < 1.0 and arg["use_labels"]:
    evals["sample_cond"] = get_sample_eval("cond_eps")
    evals["sample_cfg_1_5"] = get_sample_eval("cfg_eps_2.0")
    evals["sample_cfg_4"] = get_sample_eval("cfg_eps_4.0")
  if arg["eval_steps"] < 0:  # -1 = no evaluators (pure-throughput runs).
    evals = {}
  elif arg["eval_steps"]:  # One knob over every evaluator's cadence.
    for ev in evals.values():
      ev["log_steps"] = arg["eval_steps"]
  config["evals"] = evals

  model = dict(
      num_classes=config["num_classes"], variant=arg["variant"],
      adaln=arg["adaln"], channels=3, img_size=arg["size"],
      dtype_mm="bfloat16", attn_impl=arg["attn_impl"])
  if arg["runlocal"]:
    model.update(width=64, depth=2, dec_depth=1, num_heads=4)
    config["input"]["batch_size"] = config["batch_size"] = 32
    config["input"]["data"]["num_examples"] = 512
    config["log_training_steps"] = arg["log_steps"] or 4
    config["ckpt_steps"] = arg["ckpt_steps"] or 8
    config["evals"] = {}
  config["model"] = model
  return config
