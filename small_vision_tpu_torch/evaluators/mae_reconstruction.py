"""Masked-patch reconstruction MSE + masked/reconstructed grids.

Counterpart of small_vision_tpu/evaluators/mae_reconstruction.py:
`loss = mean((pred − true)² · mask) / mean(mask)` per example on the val
split, plus masked-input and reconstruction visualizations.
"""

import torch

from small_vision_tpu_torch.evaluators import common
from small_vision_tpu_torch.utils.misc import to_numpy


class Evaluator(common.BatchedEvaluator):
  """predict_fn = trainer "patch": (train_state, batch) -> (pred_x0, mask)."""

  def __init__(self, predict_fn, *, device, batch_size, data, pp_fn="",
               cache_final=True, num_batches=None):
    del cache_final
    super().__init__(device=device, batch_size=batch_size, data=data,
                     pp_fn=pp_fn, num_batches=num_batches)
    self.predict_fn = predict_fn

  def run(self, train_state):
    loss_sum, n_sum, firsts = 0.0, 0.0, None
    for batch in self.batches():
      images = batch["image"]
      batch_mask = batch["_mask"]  # 0 on zero-padded rows of the last batch.
      pred_x0, mask = self.predict_fn(train_state, batch)
      se = (pred_x0 - images) ** 2
      red = tuple(range(1, se.ndim))
      per_ex = (torch.mean(se * mask, dim=red)
                / torch.clamp(torch.mean(mask, dim=red), min=1e-8))
      loss_sum += float((per_ex * batch_mask).sum())
      n_sum += float(batch_mask.sum())
      if firsts is None:
        firsts = (to_numpy(images * (1 - mask)),
                  to_numpy(images * (1 - mask) + pred_x0 * mask))
    loss_sum, n_sum = common.reduce_totals(self, loss_sum, n_sum)
    yield "masked_mse", common.masked_mean(loss_sum, n_sum)
    if firsts is not None:
      yield "image_masked", firsts[0]
      yield "image_reconstruction", firsts[1]
