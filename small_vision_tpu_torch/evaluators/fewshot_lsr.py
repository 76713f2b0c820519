"""Closed-form few-shot linear probe (L2-regularised least squares).

Counterpart of small_vision_tpu/evaluators/fewshot_lsr.py: whitened
features with a `BIAS_CONSTANT` bias column, the eigh-based solver cache
(`eigh(XᵀX)` for N ≥ D, the kernel form `eigh(XXᵀ)` for D > N), and one
accuracy per (seed, dataset, shots) named `{a|z}/{ds}_{shots}shot-seed-{s}`.
The representations are the predict function's `out[representation_layer]`
(the trainer's `pre_logits`, the averaged class tokens), taken from the
real rows of each batch, every process's shard gathered in the source's
order (each process then solves the same problem). The solve runs in f32
(`torch.linalg.eigh` for the solver); the per-seed shot draws are numpy's,
as in the JAX package.
"""

import numpy as np
import torch

from small_vision_tpu_torch.data import core as ds_core
from small_vision_tpu_torch.data import pipeline
from small_vision_tpu_torch.evaluators import common
from small_vision_tpu_torch.parallel import mesh as mesh_lib
from small_vision_tpu_torch.utils.trees import tree_get

BIAS_CONSTANT = 100.0


def _whiten(x, mean, std):
  x = (x - mean) / std
  return torch.nn.functional.pad(x, (0, 1), value=BIAS_CONSTANT)


def precompute_cache(x, y, num_classes: int) -> dict:
  """The eigendecomposition cache of the least-squares solve for features
  x (N, D) and integer labels y (N,)."""
  x = x.float()
  mean = x.mean(dim=0, keepdim=True)
  std = x.std(dim=0, correction=0, keepdim=True) + 1e-5
  x = _whiten(x, mean, std)
  y = 2.0 * torch.nn.functional.one_hot(y.long(), num_classes).float() - 1.0
  n, d = x.shape
  if n >= d:
    eigs, q = torch.linalg.eigh(x.T @ x)
    rhs, lhs = q.T @ (x.T @ y), q
  else:
    eigs, q = torch.linalg.eigh(x @ x.T)
    rhs, lhs = q.T @ y, x.T @ q
  return {"eigs": eigs, "rhs": rhs, "lhs": lhs, "mean": mean, "std": std}


def solve(cache: dict, l2_reg: float) -> torch.Tensor:
  """The (D + 1, classes) weights; they do not depend on the signs eigh
  gives its eigenvectors."""
  scaling = (1.0 / (cache["eigs"] + l2_reg)).reshape(1, -1)
  return (cache["lhs"] * scaling) @ cache["rhs"]


def eig_fewshot_acc(cache: dict, x_test, y_test, l2_reg: float):
  """Accuracy of the solved probe on (x_test, y_test), a 0-d tensor."""
  x_test = _whiten(x_test.float(), cache["mean"], cache["std"])
  preds = torch.argmax(x_test @ solve(cache, l2_reg), dim=1)
  return (preds == y_test).float().mean()


class Evaluator:
  """predict_fn: (train_state, batch) -> (_, out) with the representation
  at `representation_layer` of `out`. `datasets`: {name: (train spec, test
  spec, train split, test split)}, a spec a source name or a kwargs dict
  with its `name`."""

  def __init__(self, predict_fn, *, device, batch_size, representation_layer,
               datasets, shots, l2_reg, pp_train, pp_eval, display_first,
               num_seeds=3, label_key="label", num_classes=None):
    self.predict_fn = predict_fn
    self.device = torch.device(device)
    self.batch_size = batch_size
    self.representation_layer = representation_layer
    self.datasets = datasets
    self.shots = shots
    self.l2_reg = l2_reg
    self.pp_tr, self.pp_te = pp_train, pp_eval
    self.display_first = [tuple(x) for x in display_first]
    self.num_seeds = num_seeds
    self.label_key = label_key
    self.num_classes_override = num_classes
    self._datasets = {}

  def _get_dataset(self, ds_train, ds_val, split_train, split_test):
    key = repr((ds_train, ds_val, split_train, split_test))
    if key in self._datasets:
      return self._datasets[key]
    src_tr = _get_source(ds_train, split_train)
    src_te = _get_source(ds_val, split_test)
    it_tr = pipeline.make_for_inference(src_tr, self.pp_tr, self.batch_size)
    it_te = pipeline.make_for_inference(src_te, self.pp_te, self.batch_size)
    num_classes = (self.num_classes_override
                   or getattr(src_tr, "num_classes", None) or 1000)
    return self._datasets.setdefault(key, (it_tr, it_te, num_classes))

  @torch.no_grad()
  def get_repr(self, train_state, iterate_pack):
    """(features (N, D), labels (N,)) of the real examples, on the
    device, in the source's order."""
    reps, labels, masks = [], [], []
    for batch in common.device_batches(*iterate_pack, self.device):
      masks.append(batch.pop("_mask"))
      labels.append(batch.pop(self.label_key))
      _, out = self.predict_fn(train_state, batch)
      reps.append(tree_get(out, self.representation_layer).float())
    reps, labels, masks = torch.cat(reps), torch.cat(labels), torch.cat(masks)
    if mesh_lib.process_count() > 1:
      # Every process's shard, in process order: the source's order.
      rows = common.gather_rows(self, {"x": reps, "y": labels, "m": masks})
      reps, labels, masks = (torch.from_numpy(rows[k]).to(self.device)
                             for k in ("x", "y", "m"))
    keep = masks > 0
    return reps[keep], labels[keep]

  def compute_fewshot_metrics(self, train_state, seed, ds_train, ds_val,
                              split_train, split_test):
    it_tr, it_te, num_classes = self._get_dataset(
        ds_train, ds_val, split_train, split_test)
    x_tr, y_tr = self.get_repr(train_state, it_tr)
    x_te, y_te = self.get_repr(train_state, it_te)

    rng = np.random.default_rng(seed)
    y_host = y_tr.cpu().numpy()
    class_indices = [rng.permutation(np.where(y_host == c)[0])
                     for c in range(num_classes)]
    results = {}
    for shots in self.shots:
      idx = torch.from_numpy(np.concatenate(
          [ind[:shots] for ind in class_indices])).to(self.device)
      cache = precompute_cache(x_tr[idx], y_tr[idx], num_classes)
      acc = eig_fewshot_acc(cache, x_te, y_te, self.l2_reg)
      results[shots] = float(acc)
    return results

  def run(self, train_state):
    for seed in range(self.num_seeds):
      for name, dataset_args in self.datasets.items():
        result = self.compute_fewshot_metrics(
            train_state, seed, *dataset_args)
        for shots, v in result.items():
          prefix = "a/" if (name, shots) in self.display_first else "z/"
          yield f"{prefix}{name}_{shots}shot-seed-{seed}", v


def _get_source(spec, split):
  """spec: a dataset name (with "arrays:<root>") or a kwargs dict."""
  if isinstance(spec, dict):
    spec = dict(spec)
    return ds_core.get(spec.pop("name"), split=split, **spec)
  return ds_core.get(spec, split=split)
