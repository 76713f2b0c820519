"""The sampler from a training workdir: its weights, a live callable, and an
exported artifact for serving.

Counterpart of small_vision_tpu/tools/export_sampler.py.

  - `load_params(config, workdir, use_ema=True)`: the (EMA) parameters of
    the newest checkpoint in `workdir` as a flax-named tree (a `scan=True`
    run's stacks unrolled by `convert.unstack_blocks`), falling back from
    `ema_params` to `params` as JAX does. A checkpoint of a sharded run
    holds whole tensors (`utils/checkpoint.py`), so it loads the same.
  - `build_sample_callable(config, params)`: `sample(seed) -> uint8 [B, H,
    W, C]`, the trainer's sampler on the device.
  - `export_sampler(config, params, out_path)`: a `torch.export` artifact
    (`.pt2`) of ONE DDIM step (the model's forward at a timestep tensor
    and the update, the schedule tables baked in as constants), with the
    sampler's settings beside it (`sampler.json` in the archive). The
    weights are constants in the file (`weights_mode="baked"`) or an input
    (`"arg"`: `weights_out` writes them as the flat `.npz` that
    `utils/checkpoint.py::load_params_npz` reads, optionally stored as
    bfloat16, which the program casts back to each leaf's training dtype
    as its first operation). The loop and the random draws stay outside
    the artifact: a `torch.Generator` does not cross `torch.export`, and
    126 forwards of 16 blocks in one graph are slow to export and large.
  - `load_exported_keyed(path, weights=None)` and `load_exported`: the
    artifact as `sample(generator)` and `sample(seed)`. The loader draws
    the labels (class-conditional samplers), the initial noise and each
    step's noise from the generator in the order `build_sample_callable`
    draws them, runs the loop and turns the final x0 into uint8 images, so
    both give the same bits at the same seed. Loading needs no model code
    and no config, but imports `small_vision_tpu_torch.ops`, which
    registers the kernels' forwards as the operators `torch.ops.svt.*`
    that the graph calls (the counterpart of the JAX artifact's custom
    calls): on a CUDA device they launch the kernels (and count their
    launches), on the CPU they run the plain versions. With
    `attn_impl=xla` in the config the artifact calls no attention
    operator; unlike JAX's, the port's LayerNorm is K1 under every
    `attn_impl`, so `svt::ln_modulate_fwd` stays.

  python -m small_vision_tpu_torch.tools.export_sampler \\
      --config ae_i1k.py:variant=B/4 --workdir /path/to/run \\
      --out sampler.pt2 [--weights_mode arg --weights_out ema.npz \\
      --weights_dtype bfloat16]
"""

import argparse
import json
import os

import numpy as np
import torch

from small_vision_tpu_torch import convert
from small_vision_tpu_torch.ops import diffusion as gd_lib
from small_vision_tpu_torch.train import train_ae
from small_vision_tpu_torch.utils import checkpoint as ckpt_lib
from small_vision_tpu_torch.utils.trees import tree_flatten_with_names

META = "sampler.json"  # the sampler's settings, inside the .pt2 archive


def load_params(config: dict, workdir: str, *, use_ema: bool = True):
  """(params, step, key): the newest checkpoint's `ema_params` (or, where
  the run kept no EMA or `use_ema` is False, `params`) as a nested
  flax-named tree of CPU tensors in the unrolled layout; `key` names the
  entry read. Raises FileNotFoundError without a checkpoint and when the
  names or shapes are not the config's model's."""
  mngr = ckpt_lib.make_manager(workdir, writer=False)
  step = mngr.latest_step()
  if step is None:
    raise FileNotFoundError(f"no committed checkpoint under {workdir}")
  keys = ("ema_params", "params") if use_ema else ("params",)
  for key in keys:
    try:
      tree = ckpt_lib.restore_subtree(mngr, key, step)
    except KeyError:  # the run kept no EMA
      continue
    params = convert.unstack_blocks(tree)
    convert.params_from_jax(params, train_ae.build_model(config,
                                                         device="meta"))
    return params, step, key
  raise KeyError(f"none of {keys} in the checkpoint of step {step}")


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
  gd = _diffusion(config, device)

  def sample(seed: int) -> np.ndarray:
    generator = torch.Generator(device=device).manual_seed(int(seed))
    return sample_fn(gd, generator)["fid_samples"].cpu().numpy()

  return sample


def _diffusion(config, device):
  sched = dict(config.get("diff_schedule", {}))
  return gd_lib.GaussianDiffusion.create(
      sched.get("beta_schedule", "cosine"), int(sched.get("timesteps", 1000)),
      device=device)


class _DDIMStep(torch.nn.Module):
  """One DDIM update, `(x, t, t_next, noise, y, weights) -> (x_next,
  pred_x0)`: the model's eps at (x, t) and `gd_lib.ddim_step` to `t_next`,
  where `t_next = T` (one past the schedule) stands for the final step to
  the posterior's prev index (the table `alphas_cumprod` is extended by
  `alphas_cumprod_prev[0]`, so the final step reads the very value the
  sampler loop's reads). `weights`: None (baked: the model's parameters)
  or, with `dtypes`, a flax-named {name: tensor} tree, each leaf cast to
  `dtypes[name]` first (the model's own parameters are then emptied, so
  that the exported program carries no weight)."""

  def __init__(self, model, gd, config, variant, dtypes=None):
    super().__init__()
    self.model = model
    self.names = [k.replace(".", "/") for k in model.state_dict()]
    if dtypes is not None:
      for p in model.parameters():
        p.data = p.data.new_empty(0)
    self.gd = gd_lib.GaussianDiffusion(**{
        **gd.__dict__, "alphas_cumprod": torch.cat(
            [gd.alphas_cumprod, gd.alphas_cumprod_prev[:1]])})
    self.channels = int(config.get("diffusion_space", (64, 64, 3))[-1])
    sched = config.get("diff_schedule", {})
    self.eta = float(sched.get("eta", 1.0))
    self.clip = bool(sched.get("clip_denoised", True))
    self.eps_pred = variant.get("eps_pred", True)
    self.cfg_scale = variant.get("cfg_scale")
    self.dtypes = dtypes

  def forward(self, x, t, t_next, noise, y=None, weights=None):
    model = self.model
    if weights is not None:
      weights = {k: w.to(self.dtypes[k]) for k, w in weights.items()}
      state = {k.replace("/", "."): w for k, w in convert.to_layout(
          weights, self.names).items()}
      model = lambda *a, **kw: torch.func.functional_call(
          self.model, state, a, kw)
    eps_fn = train_ae.sampler_eps_fn(model, self.gd, self.channels,
                                     self.eps_pred)
    out = gd_lib.ddim_step(self.gd, eps_fn, x, t, t_next, noise=noise,
                           eta=self.eta, clip_denoised=self.clip,
                           model_kwargs=dict(y=y, cfg_scale=self.cfg_scale))
    return out["sample"], out["pred_xstart"]


def _flat_weights(params) -> dict:
  """{flax name: tensor} of a tree of tensors or arrays."""
  return {name: torch.as_tensor(leaf)
          for name, leaf in tree_flatten_with_names(params)}


def export_sampler(config: dict, params, out_path, *, fn="uncond_eps",
                   batch_size=None, weights_mode="baked", weights_out=None,
                   weights_dtype=None, device="cuda"):
  """Exports one DDIM step of sampler `fn` at `batch_size` (default the
  config's `num_samples_per_call`) on `device` to `out_path` (a `.pt2`);
  returns the `torch.export.ExportedProgram`.

  `weights_mode`: "baked" (the weights are constants of the artifact: one
  self-contained file, ~700 MB at UMD-B in f32) or "arg" (the program
  takes them as an input; the file is the program, and `weights_out`
  writes the weights as a flat `.npz`, in `weights_dtype` such as
  "bfloat16" for the floating leaves, which halves the sidecar; the
  program casts each leaf back to its training dtype as its first
  operation)."""
  config = dict(config)
  if config.get("latent_diffusion"):
    raise ValueError("the latent sampler decodes with the VAE, which the "
                     "JAX package's exported sampler does not serve either")
  variants = train_ae.sampler_variants(config.get("num_classes"))
  if fn not in variants:
    raise KeyError(f"unknown sampler fn {fn!r}; available: "
                   f"{sorted(variants)}")
  if weights_mode not in ("baked", "arg"):
    raise ValueError(f"weights_mode must be 'baked' or 'arg', "
                     f"got {weights_mode!r}")
  b = int(batch_size or config.get("num_samples_per_call", 1024))
  variant = variants[fn]
  model = train_ae.build_model(config, device=device)
  model.load_state_dict(convert.params_from_jax(params, model))
  gd = _diffusion(config, device)
  dspace = tuple(config.get("diffusion_space", (64, 64, 3)))
  nc = variant.get("num_classes_arg")
  x = torch.zeros((b,) + dspace, device=device)
  t = torch.zeros(b, dtype=torch.long, device=device)
  y = None if nc is None else torch.zeros(b, dtype=torch.long, device=device)
  store = getattr(torch, weights_dtype) if weights_dtype else None
  if weights_mode == "baked":
    if weights_dtype or weights_out:
      raise ValueError("weights_dtype and weights_out are for "
                       "weights_mode='arg'")
    step, weights = _DDIMStep(model, gd, config, variant), None
  else:
    flat = _flat_weights(params)
    weights = {k: v.to(device=device, dtype=store if store is not None and
                       v.is_floating_point() else v.dtype)
               for k, v in flat.items()}
    step = _DDIMStep(model, gd, config, variant,
                     dtypes={k: v.dtype for k, v in flat.items()})
    assert not list(model.buffers()), "weights_mode='arg' takes parameters"
    if weights_out:
      ckpt_lib.save_params_npz(weights_out, flat, cast_floating=store)
  with torch.no_grad():  # distinct example tensors: export ties aliases
    program = torch.export.export(
        step, (x, t, t.clone(), x.clone(), y, weights))
  sched = config.get("diff_schedule", {})
  meta = {"fn": fn, "batch_size": b, "shape": [b, *dspace],
          "num_classes": nc, "weights_mode": weights_mode,
          "weights_dtype": weights_dtype or None,
          "device": torch.device(device).type,
          "timesteps": int(sched.get("timesteps", 1000)),
          "ladder": gd_lib.sampling_timesteps(
              int(sched.get("timesteps", 1000)),
              int(sched.get("sampling_timesteps", 125))).tolist()}
  # The example inputs would be saved with the program: in arg mode they
  # hold the weights.
  program.example_inputs = None
  if out_path:
    torch.export.save(program, out_path,
                      extra_files={META: json.dumps(meta)})
  return program


def load_exported_keyed(path, weights=None):
  """The artifact at `path` as `sample(generator) -> uint8 numpy [B, H, W,
  C]`, `generator` a `torch.Generator` on the artifact's device.

  An arg-mode artifact needs `weights`: a flax-named tree, or the path of
  the `.npz` that `export_sampler(..., weights_out=...)` wrote; they are
  moved to the device once, here, and reused by every call. A baked
  artifact refuses them."""
  import small_vision_tpu_torch.ops  # noqa: F401 (registers torch.ops.svt)
  extra = {META: ""}
  program = torch.export.load(path, extra_files=extra)
  meta = json.loads(extra[META])
  device = meta["device"]
  if meta["weights_mode"] == "arg":
    if weights is None:
      raise ValueError(
          f"{path} was exported with weights_mode='arg'; pass weights= "
          "(a params tree or a .npz path from weights_out)")
    if isinstance(weights, (str, os.PathLike)):
      weights = ckpt_lib.load_params_npz(weights)
    weights = {k: v.to(device) for k, v in _flat_weights(weights).items()}
  elif weights is not None:
    raise ValueError(f"{path} is a baked-weights artifact; weights= "
                     "must not be passed")
  step = program.module()
  shape, nc, ladder = tuple(meta["shape"]), meta["num_classes"], \
      meta["ladder"]
  b = shape[0]
  full = lambda v: torch.full((b,), int(v), dtype=torch.long, device=device)
  randn = lambda g: torch.randn(shape, generator=g, dtype=torch.float32,
                                device=device)

  @torch.inference_mode()
  def sample(generator: torch.Generator) -> np.ndarray:
    ys = None
    if nc is not None:  # class-balanced labels, as the trainer's sampler
      ys = torch.arange(min(nc, b), device=device)
      if b > nc:
        ys = torch.cat([ys, torch.randint(0, nc, (b - nc,),
                                          generator=generator,
                                          device=device)])
    x = randn(generator)
    for i in range(len(ladder) - 1):
      x, _ = step(x, full(ladder[i]), full(ladder[i + 1]), randn(generator),
                  ys, weights)
    _, x0 = step(x, full(0), full(meta["timesteps"]), randn(generator), ys,
                 weights)
    images = torch.clamp(x0, -1, 1) * 0.5 + 0.5
    return torch.clamp(images * 255, 0, 255).to(torch.uint8).cpu().numpy()

  sample.meta = meta
  return sample


def load_exported(path, weights=None):
  """The artifact at `path` as `sample(seed: int) -> uint8 [B, H, W, C]`;
  see `load_exported_keyed` for `weights=`."""
  keyed = load_exported_keyed(path, weights=weights)
  device = keyed.meta["device"]

  def sample(seed: int) -> np.ndarray:
    return keyed(torch.Generator(device=device).manual_seed(int(seed)))

  sample.meta = keyed.meta
  return sample


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument("--config", required=True)
  parser.add_argument("--workdir", required=True)
  parser.add_argument("--out", default="",
                      help="the exported sampler (.pt2); with --weights_out "
                           "alone, only the weights are written")
  parser.add_argument("--fn", default="uncond_eps")
  parser.add_argument("--batch_size", type=int, default=64)
  parser.add_argument("--no_ema", action="store_true")
  parser.add_argument("--weights_mode", default="baked",
                      choices=("baked", "arg"))
  parser.add_argument("--weights_out", default="",
                      help="also write the weights as a flat .npz here")
  parser.add_argument("--weights_dtype", default="",
                      help="storage dtype of the .npz's floating weights "
                           "(e.g. bfloat16: halves the sidecar)")
  parser.add_argument("--device", default="cuda")
  args = parser.parse_args(argv)

  from small_vision_tpu_torch.configs import parse_config
  config = parse_config(args.config)
  params, step, key = load_params(config, args.workdir,
                                  use_ema=not args.no_ema)
  if not args.out:
    if not args.weights_out:
      parser.error("pass --out, --weights_out or both")
    store = args.weights_dtype or None
    ckpt_lib.save_params_npz(args.weights_out, _flat_weights(params),
                             cast_floating=store)
    print(f"wrote {key} @ step {step} -> {args.weights_out}")
    return
  export_sampler(config, params, args.out, fn=args.fn,
                 batch_size=args.batch_size, weights_mode=args.weights_mode,
                 weights_out=args.weights_out or None,
                 weights_dtype=args.weights_dtype or None,
                 device=args.device)
  size = os.path.getsize(args.out)
  print(f"exported {args.fn} (weights: {key} @ step {step}, "
        f"{args.weights_mode}) bs={args.batch_size} -> {args.out} "
        f"({size / 1e6:.1f} MB)")


if __name__ == "__main__":
  main()
