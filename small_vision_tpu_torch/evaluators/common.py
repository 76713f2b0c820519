"""Config-driven evaluator construction, and what the evaluators share.

Counterpart of small_vision_tpu/evaluators/common.py: `from_config` pops the
generic keys (type/pred/pred_kw/prefix/log_*) off each `config["evals"]`
entry, imports `evaluators.<type>`, and instantiates
`Evaluator(predict_fn, device=..., **cfg)`. Each process evaluates its
shard of the data (`data.core.process_shard()`); the evaluators that sum
(`mean`, `diffusion_loss`, `mae_reconstruction`, `classification`)
all-reduce their totals over the processes that hold different rows
(`reduce_totals`, over the evaluator's `group`: every process by default,
the mesh's batch group under `from_config(..., mesh=...)`), and those that
collect examples (`fewshot_lsr`, `diffusion_sampling`, `save`) gather them
with `parallel.collectives.fetch_global`. Process 0 alone writes files.
"""

import functools
import importlib

import numpy as np
import torch

from small_vision_tpu_torch.data import core as ds_core
from small_vision_tpu_torch.data import pipeline
from small_vision_tpu_torch.parallel import collectives
from small_vision_tpu_torch.parallel import mesh as mesh_lib

# Modules of the evaluators package that hold no Evaluator: what the
# sampling evaluators' FID scoring uses.
_HELPERS = {"fid": "the FID and Inception Score functions",
            "inception": "the InceptionV3 network of FID"}


def from_config(config, predict_fns, device="cuda",
                get_steps=lambda key, cfg: cfg.get(f"{key}_steps"),
                write_note=lambda s: None, mesh=None):
  """Returns [(name, evaluator, log_steps, prefix)] from config["evals"];
  with a `mesh`, each evaluator reduces over its batch group."""
  evaluators = []
  for name, cfg in dict(config.get("evals", {})).items():
    write_note(name)
    cfg = dict(cfg)
    module_name = cfg.pop("type", name)
    pred_key = cfg.pop("pred", "predict")
    pred_kw = cfg.pop("pred_kw", None)
    prefix = cfg.pop("prefix", f"{name}/")
    cfg.pop("skip_first", None)
    log_steps = get_steps("log", cfg)
    for unit in ("steps", "epochs", "examples", "percent"):
      cfg.pop(f"log_{unit}", None)

    cfg["batch_size"] = (cfg.get("batch_size")
                         or config.get("batch_size_eval")
                         or config.get("input", {}).get("batch_size")
                         or config.get("batch_size"))

    if module_name in _HELPERS:
      raise ValueError(
          f"evaluator {name!r}: type={module_name!r} is not an evaluator but "
          f"{_HELPERS[module_name]}; a `diffusion_sampling` evaluator with "
          "the config's `inception_reference_path` set is scored with them")
    module = importlib.import_module(
        f"small_vision_tpu_torch.evaluators.{module_name}")
    try:
      predict_fn = predict_fns[pred_key]
    except KeyError as e:
      raise ValueError(
          f"Unknown predict_fn {pred_key!r}. Available: "
          f"{sorted(predict_fns)}") from e
    if pred_kw is not None:
      predict_fn = functools.partial(predict_fn, **dict(pred_kw))
    try:
      evaluator = module.Evaluator(predict_fn, device=device, **cfg)
    except TypeError as e:
      # Evaluators take explicit kwargs only (no **unused_kw swallowing), so
      # a typo'd config key (e.g. `totall_samples`) fails loudly here.
      raise ValueError(
          f"Bad config for evaluator {name!r} (type={module_name!r}): {e}. "
          f"Config keys passed: {sorted(cfg)}") from e
    if mesh is not None:
      evaluator.group = mesh.batch_group()
    evaluators.append((name, evaluator, log_steps, prefix))
  return evaluators


def reduce_totals(evaluator, *totals):
  """The evaluator's per-process totals summed over its `group` (default:
  every process), as floats."""
  group = getattr(evaluator, "group", collectives.WORLD)
  return [float(v) for v in collectives.all_reduce_host(list(totals), group)]


def gather_rows(evaluator, tree):
  """Host numpy of the rows of every process in the evaluator's `group`."""
  return collectives.fetch_global(
      tree, getattr(evaluator, "group", collectives.WORLD))


def is_writer() -> bool:
  """True on the process that writes files (process 0)."""
  return mesh_lib.process_index() == 0


def device_batches(iterate, device_pp, n_steps, device):
  """The first `n_steps` batches of `iterate()` on `device`, after the
  device pp, whose random ops draw from a generator seeded 0."""
  gen = torch.Generator(device=device).manual_seed(0)
  for i, batch in enumerate(iterate()):
    if i >= n_steps:
      break
    batch = pipeline.to_device(batch, device)
    n = batch["_mask"].shape[0]
    yield device_pp(batch, device_pp.draw(n, gen, device))


class BatchedEvaluator:
  """An evaluator over a data source's ordered examples: the source, the
  inference pipeline (the host stage of `pp_fn` on its workers, fixed-size
  batches, the last zero-padded, `_mask` on the real rows) and the device
  stage, whose random ops draw from a generator seeded 0 at each run."""

  def __init__(self, *, device, batch_size, data, pp_fn="", num_batches=None):
    data = dict(data)
    source = ds_core.get(data.pop("name"), **data)
    self.iterate, self.device_pp, self.n_steps = pipeline.make_for_inference(
        source, pp_fn, batch_size)
    if num_batches:
      self.n_steps = min(self.n_steps, num_batches)
    self.device = torch.device(device)

  def batches(self):
    """The run's batches on the device, after the device pp."""
    return device_batches(self.iterate, self.device_pp, self.n_steps,
                          self.device)


def masked_mean(total: float, count: float) -> float:
  return float(total / max(count, 1.0))
