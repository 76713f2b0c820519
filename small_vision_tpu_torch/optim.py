"""The UMD trainer's AdamW, over lists of parameter tensors.

Counterpart of small_vision_tpu/optim.py::adamw_trainer_tx, i.e. of
    optax.chain(optax.clip_by_global_norm(clip_norm),
                optax.adamw(warmup_cosine_decay_schedule, b1, b2,
                            weight_decay=wd, mask=decay_mask,
                            mu_dtype="bfloat16"))
in optax's order and at its rounding points, written with
`torch._foreach_*` ops. `torch.optim.AdamW` is not that function: it
decays the weights before the Adam step, and keeps its moments in the
parameter's dtype. One step:
  1. clip: when the global norm |g| of the gradients is at least
     `clip_norm`, g = (g / |g|) * clip_norm;
  2. Adam: mu = (1 - b1) g + b1 mu_prev, where mu_prev is the stored bf16
     moment and b1 * mu_prev is rounded to bf16 (JAX multiplies a bf16
     array by a Python float in bf16); mu is used unrounded for this step
     and stored in bf16. nu = (1 - b2) g² + b2 nu_prev in f32. With
     count = step number (from 1), u = (mu / (1 - b1^count)) /
     (sqrt(nu / (1 - b2^count)) + eps);
  3. u += wd * p for every parameter under the decay mask;
  4. u *= -lr(step - 1), the warmup-cosine schedule of optax;
  5. p += u.
The decay mask exempts a parameter when any `/`-token of its flax name is
in `no_decay_list`; `head_bias` and the LayerNorm `scale`s are decayed.
"""

from typing import Sequence

import numpy as np
import torch

NO_DECAY = ("cls", "mask_token", "bias")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def decay_mask(names: Sequence[str], no_decay_list=NO_DECAY) -> list:
  """True for each flax name that weight decay applies to."""
  return [all(tok not in name.split("/") for tok in no_decay_list)
          for name in names]


def warmup_cosine(count: int, *, peak: float, warmup_steps: int,
                  decay_steps: int) -> float:
  """optax.warmup_cosine_decay_schedule(0, peak, warmup_steps,
  decay_steps)(count), in f32 as optax computes it."""
  f32 = np.float32
  if count < warmup_steps:
    frac = f32(1) - f32(count) / f32(warmup_steps)
    return float(f32(0.0 - peak) * frac + f32(peak))
  c = f32(min(count - warmup_steps, decay_steps - warmup_steps))
  cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c /
                                       f32(decay_steps - warmup_steps)))
  return float(f32(peak) * cosine)


def global_norm(tensors) -> torch.Tensor:
  """sqrt of the sum of squares of every element, as an f32 0-d tensor."""
  norms = torch._foreach_norm([t.float() for t in tensors])
  return torch.linalg.vector_norm(torch.stack(norms))


def ema_update(ema, params, step_size: float):
  """optax.incremental_update, in place on `ema`:
  ema = step_size * params + (1 - step_size) * ema."""
  new = torch._foreach_mul(params, step_size)
  torch._foreach_mul_(ema, 1.0 - step_size)
  torch._foreach_add_(ema, new)


class AdamW:
  """The trainer's optimizer over the parameters named `names` (flax
  names, in the order the parameter lists are given).

  State: {"count": steps taken, "mu": bf16 tensors, "nu": f32 tensors}.
  """

  def __init__(self, names: Sequence[str], *, peak_lr: float,
               batch_size: int, total_steps: int, warmup_steps: int,
               wd: float, betas=(0.9, 0.95), clip_norm: float = 1.0,
               no_decay_list=NO_DECAY, mu_dtype: str = "bfloat16",
               eps: float = 1e-8):
    self.names = list(names)
    self.decay = decay_mask(self.names, no_decay_list)
    self.warmup_steps = min(max(warmup_steps, 1), max(total_steps - 1, 1))
    self.total_steps = total_steps
    self.peak = peak_lr * batch_size / 256.0
    self.wd = wd
    self.b1, self.b2 = betas
    self.clip_norm = clip_norm
    self.mu_dtype = DTYPES[mu_dtype]
    self.eps = eps
    # b1 as JAX applies it to the stored moment: rounded to its dtype.
    self._b1_mu = float(torch.tensor(self.b1, dtype=self.mu_dtype))

  def lr(self, count: int) -> float:
    """The learning rate of the update with schedule count `count` (the
    number of updates before it)."""
    return warmup_cosine(count, peak=self.peak,
                         warmup_steps=self.warmup_steps,
                         decay_steps=self.total_steps)

  def init(self, params) -> dict:
    return {"count": 0,
            "mu": [torch.zeros_like(p, dtype=self.mu_dtype) for p in params],
            "nu": [torch.zeros_like(p, dtype=torch.float32) for p in params]}

  def step(self, params, grads, state, *, with_l2=False, norm=None,
           clip_norm="config") -> dict:
    """Updates `params` (f32 tensors) and `state` in place from `grads`.

    Returns {"l2_params", "l2_updates", "l2_grads"} (0-d tensors, after the
    update) when `with_l2`, else {}. Reads the global norm of the
    gradients on the host once (the clip's branch). `norm`: the function
    of a tensor list that gives its global norm (default `global_norm`; a
    sharded step passes one that sums over the shards, so that the update
    of local shards is the update of the whole). `clip_norm`: the clip's
    threshold, by default the optimizer's; None does not clip.
    """
    f32 = np.float32
    norm = norm or global_norm
    clip_norm = self.clip_norm if clip_norm == "config" else clip_norm
    g_norm = norm(grads)
    metrics = {"l2_grads": g_norm} if with_l2 else {}
    if clip_norm is not None and not bool(g_norm < clip_norm):
      grads = torch._foreach_div(grads, g_norm)
      torch._foreach_mul_(grads, clip_norm)

    count = state["count"] + 1
    mu = torch._foreach_mul(grads, 1.0 - self.b1)
    torch._foreach_add_(mu, torch._foreach_mul(state["mu"], self._b1_mu))
    torch._foreach_mul_(state["nu"], self.b2)
    g2 = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(g2, 1.0 - self.b2)
    torch._foreach_add_(state["nu"], g2)
    bc1 = float(f32(1) - f32(self.b1) ** f32(count))
    bc2 = float(f32(1) - f32(self.b2) ** f32(count))
    denom = torch._foreach_div(state["nu"], bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, self.eps)
    updates = torch._foreach_div(mu, bc1)
    torch._foreach_div_(updates, denom)
    state["mu"] = [m.to(self.mu_dtype) for m in mu]

    decayed = [i for i, d in enumerate(self.decay) if d]
    if self.wd and decayed:
      wp = torch._foreach_mul([params[i] for i in decayed], self.wd)
      torch._foreach_add_([updates[i] for i in decayed], wp)
    torch._foreach_mul_(updates, -self.lr(state["count"]))
    torch._foreach_add_(params, updates)
    state["count"] = count
    if with_l2:
      metrics["l2_params"] = norm(params)
      metrics["l2_updates"] = norm(updates)
    return metrics


class LarsProbe:
  """The linear probe's LARS, `optax.lars(warmup_cosine_decay_schedule(0,
  base_lr * batch_size / 256, warmup_steps, total_steps), momentum=0.9)`
  (JAX `optim.lars_probe_tx`), over lists of f32 tensors, in optax 0.2.6's
  order. One step, per parameter:
    1. u = g (optax adds the decayed weights, with weight decay 0);
    2. the trust ratio: u *= 0.001 * |p| / |u|, or 1 where |p| or |u| is
       0 (the zero-initialised bias at step 1);
    3. u *= -lr(count), the count taken before its increment;
    4. the momentum trace: trace = u + 0.9 * trace (not Nesterov); p +=
       trace.

  State: {"count": updates taken, "trace": tensors like the params}.
  """

  def __init__(self, *, base_lr: float, batch_size: int, total_steps: int,
               warmup_steps: int, momentum: float = 0.9,
               trust_coefficient: float = 0.001):
    self.warmup_steps = min(max(warmup_steps, 1), max(total_steps - 1, 1))
    self.total_steps = total_steps
    self.peak = base_lr * batch_size / 256.0
    self.momentum = momentum
    self.trust = trust_coefficient

  def lr(self, count: int) -> float:
    return warmup_cosine(count, peak=self.peak,
                         warmup_steps=self.warmup_steps,
                         decay_steps=self.total_steps)

  def init(self, params) -> dict:
    return {"count": 0, "trace": [torch.zeros_like(p) for p in params]}

  def step(self, params, grads, state):
    """Updates `params` and `state` in place from `grads`."""
    lr = np.float32(self.lr(state["count"]))
    for p, u, tr in zip(params, grads, state["trace"]):
      p_norm = torch.linalg.vector_norm(p)
      u_norm = torch.linalg.vector_norm(u)
      ratio = torch.where((p_norm == 0) | (u_norm == 0),
                          torch.ones_like(p_norm),
                          self.trust * p_norm / u_norm)
      u = u * ratio * -lr
      tr.mul_(self.momentum).add_(u)
      p.add_(tr)
    state["count"] += 1
