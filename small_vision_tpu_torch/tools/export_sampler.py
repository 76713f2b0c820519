"""The sampler as one callable: `sample(seed) -> uint8 [B, H, W, C]`.

Counterpart of small_vision_tpu/tools/export_sampler.py::build_sample_callable.
The weights are a flax-named tree (for example the .npz that the JAX
package's `export_sampler --weights_out` writes, read with
`utils.checkpoint.load_params_npz`), loaded once onto the device. The JAX
package's `jax.export` artifacts have no counterpart in the port.
"""

import numpy as np
import torch

from small_vision_tpu_torch import convert
from small_vision_tpu_torch.ops import diffusion as gd_lib
from small_vision_tpu_torch.train import train_ae


def build_sample_callable(config: dict, params, *, fn="uncond_eps",
                          batch_size=None, device="cuda"):
  """seed (int) -> uint8 numpy images [B, H, W, C], weights closed over.

  `fn` is a key of the trainer's sampler suite (uncond_eps, cond_eps,
  cfg_eps_1.5, ...); `batch_size` overrides `num_samples_per_call`.
  """
  config = dict(config)
  if batch_size:
    config["num_samples_per_call"] = int(batch_size)
  model = train_ae.build_model(config, device=device)
  model.load_state_dict(convert.params_from_jax(params, model))
  eval_fns = train_ae.make_eval_fns(model, config)
  if fn not in eval_fns:
    raise KeyError(f"unknown sampler fn {fn!r}; available: "
                   f"{sorted(eval_fns)}")
  sample_fn = eval_fns[fn]
  sched = dict(config.get("diff_schedule", {}))
  gd = gd_lib.GaussianDiffusion.create(
      sched.get("beta_schedule", "cosine"), int(sched.get("timesteps", 1000)),
      device=device)

  def sample(seed: int) -> np.ndarray:
    generator = torch.Generator(device=device).manual_seed(int(seed))
    return sample_fn(gd, generator)["fid_samples"].cpu().numpy()

  return sample
