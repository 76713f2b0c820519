"""Generic mean-of-per-example-metrics evaluator.

Counterpart of small_vision_tpu/evaluators/mean.py: the predict_fn returns a
dict of per-example metric tensors; this evaluator accumulates
`_mask`-weighted sums and yields their normalised means.
"""

from small_vision_tpu_torch.evaluators import common


class Evaluator(common.BatchedEvaluator):

  def __init__(self, predict_fn, *, device, batch_size, data, pp_fn="",
               cache_final=True):
    del cache_final
    super().__init__(device=device, batch_size=batch_size, data=data,
                     pp_fn=pp_fn)
    self.predict_fn = predict_fn

  def run(self, train_state):
    totals, nseen = None, 0.0
    for batch in self.batches():
      mask = batch["_mask"]
      metrics = self.predict_fn(train_state, batch)
      sums = {k: float((v * mask).sum()) for k, v in metrics.items()}
      nseen += float(mask.sum())
      totals = sums if totals is None else {
          k: totals[k] + sums[k] for k in totals}
    if totals is None:
      return
    for key in totals:
      yield key, common.masked_mean(totals[key], nseen)
