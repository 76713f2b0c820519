"""Validation diffusion loss + first-batch visualizations.

Counterpart of small_vision_tpu/evaluators/diffusion_loss.py: the loss over
the val split, plus x_t / pred-x0 / pred-x0-from-eps image tensors from the
first batch for qualitative tracking.
"""

from small_vision_tpu_torch.evaluators import common
from small_vision_tpu_torch.utils.misc import to_numpy


class Evaluator(common.BatchedEvaluator):
  """predict_fn = trainer "loss": (train_state, batch) ->
  (per_example_loss, x_t, pred_x0, pred_x0_eps).

  The final batch of a split is zero-padded up to batch_size with `_mask`=0
  rows; the reported loss is the mask-weighted mean over REAL examples,
  accumulated as (sum, count) across batches so that ragged batches carry
  their true weight. The sums are over every process's rows; the images
  are this process's first batch."""

  def __init__(self, predict_fn, *, device, batch_size, data, pp_fn="",
               cache_final=True, num_batches=None):
    del cache_final
    super().__init__(device=device, batch_size=batch_size, data=data,
                     pp_fn=pp_fn, num_batches=num_batches)
    self.predict_fn = predict_fn

  def run(self, train_state):
    loss_sum, n_sum, firsts = 0.0, 0.0, None
    for batch in self.batches():
      mask = batch["_mask"]
      loss, *images = self.predict_fn(train_state, batch)
      loss_sum += float((loss * mask).sum())
      n_sum += float(mask.sum())
      if firsts is None:
        firsts = [to_numpy(t) for t in images]
    loss_sum, n_sum = common.reduce_totals(self, loss_sum, n_sum)
    yield "loss", common.masked_mean(loss_sum, n_sum)
    if firsts is not None:
      x_t, pred_x0, pred_x0_eps = firsts
      yield "image_x_t", x_t
      yield "image_pred_x0", pred_x0
      yield "image_pred_x0_eps", pred_x0_eps
