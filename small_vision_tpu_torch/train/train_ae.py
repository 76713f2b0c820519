"""The model builder and the sampler functions of the UMD trainer.

Counterpart of small_vision_tpu/train/train_ae.py: `build_model` and, from
`make_eval_fns`, the sampler suite (`make_apply_fn`, `make_sample_fn`):
uncond_eps, and with `num_classes` cond_eps, cfg_eps_* and cfg_x0_*. The
training step and the other evaluator functions come with their slices.

A sampler function is `sample_fn(gd, generator, *, noise=None)`: the model
holds its (EMA) weights, `gd` the diffusion tables, `generator` draws the
noise and labels on the model's device, and `noise` optionally injects the
loop's draws (see `ops.diffusion.ddim_sample_loop`).
"""

import importlib

import torch

from small_vision_tpu_torch.ops import diffusion as gd_lib


def build_model(config: dict, device="cuda") -> torch.nn.Module:
  """The config's model, in eval mode, parameters uninitialised."""
  model_mod = importlib.import_module(
      f"small_vision_tpu_torch.models.{config.get('model_name', 'ae')}")
  with torch.device(device):
    model = model_mod.Model(**dict(config.get("model", {})))
  return model.eval().requires_grad_(False)


def make_eval_fns(model, config: dict) -> dict:
  """The sampler functions the evaluators and the server consume."""
  dspace = tuple(config.get("diffusion_space", (64, 64, 3)))
  channels = int(dspace[-1])
  num_classes = config.get("num_classes", None)
  sched = config.get("diff_schedule", {})
  sampling_steps = int(sched.get("sampling_timesteps", 125))
  eta = float(sched.get("eta", 1.0))
  clip_denoised = bool(sched.get("clip_denoised", True))

  def make_apply_fn(gd, eps_pred=True):
    """The sampler's eps model: the t+1 shift and optional CFG."""

    def apply_fn(*, x_t, t, y=None, cfg_scale=None):
      pred, _ = model(x_t, t=t + 1, y=y, cfg_scale=cfg_scale)
      if eps_pred:
        return pred[..., channels:]
      return gd_lib.predict_eps_from_xstart(gd, x_t, t, pred[..., :channels])
    return apply_fn

  def make_sample_fn(num_classes_arg=None, manual_ys=None, cfg_scale=None,
                     unnormalize=True, eps_pred=True):

    @torch.inference_mode()
    def sample_fn(gd, generator, *, noise=None):
      num_samples = int(config.get("num_samples_per_call", 1024))
      device = gd.betas.device
      if num_classes_arg is not None and manual_ys is None:
        # Class-balanced labels: every class once, random fill to the call
        # size; calls smaller than the class count cover the first classes.
        ys = torch.arange(min(num_classes_arg, num_samples), device=device)
        if num_samples > num_classes_arg:
          ys = torch.cat([ys, torch.randint(
              0, num_classes_arg, (num_samples - num_classes_arg,),
              generator=generator, device=device)])
      elif manual_ys is not None:
        ys = torch.as_tensor(manual_ys, device=device)
      else:
        ys = None

      out = gd_lib.ddim_sample_loop(
          gd, make_apply_fn(gd, eps_pred=eps_pred),
          (num_samples,) + dspace, generator=generator, noise=noise, ys=ys,
          cfg_scale=cfg_scale, sampling_steps=sampling_steps, eta=eta,
          clip_denoised=clip_denoised)
      samples = out["sample"]
      if unnormalize:
        samples = torch.clamp(samples, -1, 1) * 0.5 + 0.5
        samples = torch.clamp(samples * 255, 0, 255).to(torch.uint8)

      n_show = int(config.get("num_samples", 36))
      show_idx = torch.randint(0, num_samples, (n_show,),
                               generator=generator, device=device)
      return {"fid_samples": samples, "image_examples": samples[show_idx],
              "ys": ys}
    return sample_fn

  fns = {"uncond_eps": make_sample_fn()}
  if num_classes:
    fns.update({
        "cond_eps": make_sample_fn(num_classes),
        "cfg_eps_1.0": make_sample_fn(num_classes, cfg_scale=1.0),
        "cfg_eps_1.5": make_sample_fn(num_classes, cfg_scale=1.5),
        "cfg_eps_2.0": make_sample_fn(num_classes, cfg_scale=2.0),
        "cfg_eps_4.0": make_sample_fn(num_classes, cfg_scale=4.0),
        "cfg_x0_2.0": make_sample_fn(num_classes, cfg_scale=2.0,
                                     eps_pred=False),
        "cfg_x0_4.0": make_sample_fn(num_classes, cfg_scale=4.0,
                                     eps_pred=False),
    })
  return fns
