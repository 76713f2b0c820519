"""Gaussian diffusion core: schedule tables and the DDIM sampler.

Counterpart of small_vision_tpu/ops/diffusion.py. Tables are built in
float64 numpy exactly as there and stored as float32 tensors, so they are
bit-equal to the JAX package's. JAX PRNG streams cannot be reproduced in
torch, so `ddim_step` and `ddim_sample_loop` draw from an explicit
`torch.Generator` and accept injected noise instead (the parity tests feed
them the JAX draws). Timesteps are (B,) int64 tensors.
"""

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch


def make_beta_schedule(name: str, timesteps: int) -> np.ndarray:
  """Beta schedule table in float64 (values match DDPM/iDDPM conventions)."""
  if name == "linear":
    scale = 1000.0 / timesteps
    return np.linspace(scale * 1e-4, scale * 2e-2, timesteps,
                       dtype=np.float64)
  if name == "cosine":
    # iDDPM cosine: beta_t = 1 - abar(t+1)/abar(t), capped at 0.999.
    def alpha_bar(t):
      return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
    grid = np.arange(timesteps + 1, dtype=np.float64) / timesteps
    abar = alpha_bar(grid)
    betas = 1.0 - abar[1:] / abar[:-1]
    return np.minimum(betas, 0.999)
  raise NotImplementedError(f"Unknown beta schedule: {name!r}")


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
  """Precomputed diffusion tables: (T,) float32 tensors on one device."""
  betas: torch.Tensor
  alphas_cumprod: torch.Tensor
  alphas_cumprod_prev: torch.Tensor
  sqrt_alphas_cumprod: torch.Tensor
  sqrt_one_minus_alphas_cumprod: torch.Tensor
  sqrt_recip_alphas_cumprod: torch.Tensor
  sqrt_recipm1_alphas_cumprod: torch.Tensor
  posterior_mean_coef1: torch.Tensor
  posterior_mean_coef2: torch.Tensor
  posterior_variance: torch.Tensor
  posterior_log_variance_clipped: torch.Tensor

  @property
  def num_timesteps(self) -> int:
    return self.betas.shape[0]

  @classmethod
  def create(cls, beta_schedule: str = "cosine", timesteps: int = 1000,
             device="cuda") -> "GaussianDiffusion":
    betas = make_beta_schedule(beta_schedule, timesteps)
    alphas = 1.0 - betas
    acp = np.cumprod(alphas)
    acp_prev = np.append(1.0, acp[:-1])
    post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
    post_logvar = np.log(np.append(post_var[1], post_var[1:]))
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    return cls(
        betas=f32(betas),
        alphas_cumprod=f32(acp),
        alphas_cumprod_prev=f32(acp_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(acp)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1 - acp)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1 / acp)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1 / acp - 1)),
        posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
        posterior_mean_coef2=f32(
            (1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
        posterior_variance=f32(post_var),
        posterior_log_variance_clipped=f32(post_logvar),
    )


def bcast(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
  """Gathers table[t] for a (B,) or (B,1) t and appends broadcast dims."""
  vals = table[t.reshape(t.shape[0])]
  return vals.reshape((-1,) + (1,) * (ndim - 1))


def q_sample(gd: GaussianDiffusion, x_start, t, noise):
  """Forward noising: draw x_t ~ q(x_t | x_0) given the noise."""
  nd = x_start.ndim
  return (bcast(gd.sqrt_alphas_cumprod, t, nd) * x_start +
          bcast(gd.sqrt_one_minus_alphas_cumprod, t, nd) * noise)


def predict_xstart_from_eps(gd: GaussianDiffusion, x_t, t, eps):
  nd = x_t.ndim
  return (bcast(gd.sqrt_recip_alphas_cumprod, t, nd) * x_t -
          bcast(gd.sqrt_recipm1_alphas_cumprod, t, nd) * eps)


def predict_eps_from_xstart(gd: GaussianDiffusion, x_t, t, x_start):
  nd = x_t.ndim
  return ((bcast(gd.sqrt_recip_alphas_cumprod, t, nd) * x_t - x_start) /
          bcast(gd.sqrt_recipm1_alphas_cumprod, t, nd))


def ddim_step(gd: GaussianDiffusion, eps_fn: Callable, x, t, t_next, *,
              generator: Optional[torch.Generator] = None,
              noise: Optional[torch.Tensor] = None, eta: float = 1.0,
              clip_denoised: bool = False, model_kwargs=None):
  """One eta-parameterized DDIM update x_t -> x_{t_next} (DDIM Eq. 12).

  `eps_fn(x_t=..., t=..., **model_kwargs)` returns predicted noise.
  `t_next=None` means the final step to the posterior-prev index. The step
  noise is `noise` when given, else a draw from `generator`.
  Returns dict(sample, pred_xstart).
  """
  model_kwargs = model_kwargs or {}
  eps_out = eps_fn(x_t=x, t=t, **model_kwargs)

  pred_xstart = predict_xstart_from_eps(gd, x, t, eps_out)
  if clip_denoised:
    pred_xstart = torch.clamp(pred_xstart, -1.0, 1.0)
  # Re-derive eps from the (possibly clipped) x0 so the update is consistent.
  eps = predict_eps_from_xstart(gd, x, t, pred_xstart)

  nd = x.ndim
  alpha_bar = bcast(gd.alphas_cumprod, t, nd)
  if t_next is not None:
    alpha_bar_prev = bcast(gd.alphas_cumprod, t_next, nd)
  else:
    alpha_bar_prev = bcast(gd.alphas_cumprod_prev, t, nd)

  sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar)) *
           torch.sqrt(1 - alpha_bar / alpha_bar_prev))
  mean = (pred_xstart * torch.sqrt(alpha_bar_prev) +
          torch.sqrt(torch.clamp(1 - alpha_bar_prev - sigma**2, min=0.0))
          * eps)
  if noise is None:
    noise = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                        device=x.device)
  nonzero = (t.reshape(-1) > 0).to(x.dtype).reshape((-1,) + (1,) * (nd - 1))
  sample = mean + nonzero * sigma * noise
  return {"sample": sample, "pred_xstart": pred_xstart}


def sampling_timesteps(num_train_steps: int, num_sample_steps: int):
  """The strided timestep ladder T-1 … 0 used by the reference sampler."""
  ts = np.arange(num_train_steps - 1, 0,
                 -(num_train_steps // num_sample_steps), dtype=np.int32)
  return np.append(ts, 0).astype(np.int32)


def ddim_sample_loop(gd: GaussianDiffusion, eps_fn: Callable, shape, *,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[Sequence[torch.Tensor]] = None,
                     ys=None, cfg_scale: Optional[float] = None,
                     sampling_steps: int = 250, eta: float = 1.0,
                     clip_denoised: bool = False):
  """Full DDIM sampling: `sampling_steps` strided steps + a final t=0 step.

  `noise`, when given, holds `sampling_steps + 2` tensors of `shape`: the
  initial x_T, then the noise of each step in order (the final step's is
  multiplied by zero, as in the JAX loop). Otherwise every draw comes from
  `generator`. Returns dict(sample, y); `sample` is the final predicted x0.
  """
  device = gd.betas.device
  if noise is not None and len(noise) != sampling_steps + 2:
    raise ValueError(f"noise holds {len(noise)} tensors, the loop needs "
                     f"{sampling_steps + 2}")
  draw = lambda i: (noise[i].to(device) if noise is not None else
                    torch.randn(shape, generator=generator,
                                dtype=torch.float32, device=device))
  model_kwargs = dict(y=ys, cfg_scale=cfg_scale)
  x = draw(0)
  b = shape[0]
  ladder = sampling_timesteps(gd.num_timesteps, sampling_steps)
  full = lambda v: torch.full((b,), int(v), dtype=torch.long, device=device)

  for i in range(sampling_steps):
    x = ddim_step(gd, eps_fn, x, full(ladder[i]), full(ladder[i + 1]),
                  noise=draw(i + 1), eta=eta, clip_denoised=clip_denoised,
                  model_kwargs=model_kwargs)["sample"]

  final = ddim_step(gd, eps_fn, x, full(0), None,
                    noise=draw(sampling_steps + 1), eta=eta,
                    clip_denoised=clip_denoised, model_kwargs=model_kwargs)
  return {"sample": final["pred_xstart"], "y": ys}
