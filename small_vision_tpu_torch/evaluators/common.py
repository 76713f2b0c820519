"""Config-driven evaluator construction, and what the evaluators share.

Counterpart of small_vision_tpu/evaluators/common.py: `from_config` pops the
generic keys (type/pred/pred_kw/prefix/log_*) off each `config["evals"]`
entry, imports `evaluators.<type>`, and instantiates
`Evaluator(predict_fn, device=..., **cfg)`. One process on one device:
where the JAX evaluators gather across processes, these just read their own
totals.
"""

import functools
import importlib

import torch

from small_vision_tpu_torch.data import core as ds_core
from small_vision_tpu_torch.data import pipeline

# Evaluators of the JAX package that are not ported yet.
_NOT_PORTED = {
    "fewshot_lsr": "the evaluators slice (it needs the eigh solver and the "
                   "train-split features)",
    "classification": "the evaluators slice, with the linear probe",
    "fid": "the evaluators slice (StreamingMoments, Fréchet, IS)",
    "inception": "the evaluators slice (InceptionV3 weights are not in the "
                 "repository)",
}


def from_config(config, predict_fns, device="cuda",
                get_steps=lambda key, cfg: cfg.get(f"{key}_steps"),
                write_note=lambda s: None):
  """Returns [(name, evaluator, log_steps, prefix)] from config["evals"]."""
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

    if module_name in _NOT_PORTED:
      raise NotImplementedError(
          f"evaluator {name!r} (type={module_name!r}) is not ported: it "
          f"comes with {_NOT_PORTED[module_name]}")
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
    evaluators.append((name, evaluator, log_steps, prefix))
  return evaluators


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
    gen = torch.Generator(device=self.device).manual_seed(0)
    for i, batch in enumerate(self.iterate()):
      if i >= self.n_steps:
        break
      batch = pipeline.to_device(batch, self.device)
      n = batch["_mask"].shape[0]
      yield self.device_pp(batch, self.device_pp.draw(n, gen, self.device))


def masked_mean(total: float, count: float) -> float:
  return float(total / max(count, 1.0))
