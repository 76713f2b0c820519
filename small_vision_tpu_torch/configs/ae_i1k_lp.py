"""The linear-probe config, as a plain dict.

Counterpart of small_vision_tpu/configs/ae_i1k_lp.py: one-hot labels in
the pp, LARS at `lr · bs/256` over the frozen UMD's features, the
classification evaluators on `train[:2%]`, `train[99%:]` and `validation`
(none on synthetic data). `pretrain_workdir` is the workdir of a
`train_ae` run, whose newest checkpoint's `params` the backbone takes;
without it the backbone is seeded. The training pp of any data but
`synthetic` starts with `decode_jpeg_and_inception_crop`, as the JAX
config's does; a caller with decoded images (an `arrays` source) sets
`input.pp` and the evaluators' `pp_fn` itself.

  --config ae_i1k_lp.py:variant=B/4,size=64,pretrain_workdir=/tmp/run
  --config ae_i1k_lp.py:runlocal,data=synthetic      # tiny CPU run
  --config ae_i1k_lp.py:scan=True,pretrain_workdir=/tmp/run   # a backbone
                      # trained with scan=True (stacked layout)
"""

from small_vision_tpu_torch.configs import common as cc


def get_config(arg=None) -> dict:
  arg = cc.parse_arg(
      arg, variant="B/4", batch_size=1024, size=64, adaln=True, epochs=90,
      use_noised_pred=False, latent_diffusion=False, scan=False,
      data="imagenet2012",
      pretrain_workdir="", lr=0.1, wd=0.0, runlocal=False)

  config = {
      "seed": 0,
      "size": arg["size"],
      "diffusion_space": (arg["size"], arg["size"], 3),
      "num_classes": 1000,
      "total_epochs": arg["epochs"],
      "use_noised_pred": arg["use_noised_pred"],
      "pretrain_workdir": arg["pretrain_workdir"] or None,
      "peak_lr": arg["lr"],
      "wd": arg["wd"],
      "width": {"S": 384, "B": 768, "L": 1024}[arg["variant"].split("/")[0]],
      "diff_schedule": dict(beta_schedule="cosine", timesteps=1000),
      "log_training_steps": 100,
      "model_name": "ae",
  }
  data = arg["data"]
  if data == "synthetic":
    data_cfg = dict(name="synthetic", img_size=arg["size"])
    pp_train = ""
  else:
    data_cfg = dict(name=data, split="train[:99%]")
    pp_train = (f"decode_jpeg_and_inception_crop(size={arg['size']}, "
                "area_min=80)")
  pp_common = ('|flip_lr|value_range(-1, 1)'
               '|onehot(1000, key="label", key_result="labels")'
               '|keep("image", "labels")')
  config["input"] = {"data": data_cfg, "pp": pp_train + pp_common,
                     "batch_size": arg["batch_size"], "num_workers": 16}
  config["model"] = dict(num_classes=None, variant=arg["variant"],
                         scan=arg["scan"], adaln=arg["adaln"], channels=3,
                         img_size=arg["size"], dtype_mm="bfloat16")

  pp_eval = (f"decode|resize_small({arg['size']})|central_crop({arg['size']})"
             '|value_range(-1, 1)|keep("image", "label")')
  if data == "synthetic":
    pp_eval = 'value_range(-1, 1)|keep("image", "label")'

  def get_class_eval(split):
    return dict(type="classification", data=dict(name=data, split=split),
                pp_fn=pp_eval, pred="predict", log_steps=5000)

  config["evals"] = {}
  if data != "synthetic":
    config["evals"]["train"] = get_class_eval("train[:2%]")
    config["evals"]["minival"] = get_class_eval("train[99%:]")
    config["evals"]["val"] = get_class_eval("validation")

  if arg["runlocal"]:  # a tiny CPU run (as ae_i1k.py's runlocal)
    config["input"].update(batch_size=16, num_workers=2)
    config.update(num_classes=10, width=32, evals={}, total_steps=6,
                  ckpt_steps=3, log_training_steps=1)
    del config["total_epochs"]
    if data == "synthetic":
      config["input"]["data"].update(num_examples=128, num_classes=10)
      config["input"]["pp"] = config["input"]["pp"].replace("onehot(1000",
                                                            "onehot(10")
    config["model"] = dict(width=32, depth=1, dec_depth=1, num_heads=4,
                           img_size=arg["size"], patch_size=(4, 4),
                           scan=False, adaln=arg["adaln"], num_classes=None,
                           dtype_mm="float32")
  return config
