"""Top-1 accuracy and cross-entropy over a split, padded rows excluded.

Counterpart of small_vision_tpu/evaluators/classification.py: sums weighted
by `_mask`, so the zero-padded rows of the last batch do not bias the
metrics; labels may be integers or one-hot. The totals are summed over the
processes.
"""

import torch

from small_vision_tpu_torch.evaluators import common


class Evaluator(common.BatchedEvaluator):
  """predict_fn: (train_state, batch) -> (logits, ...); the labels under
  `label_key`."""

  def __init__(self, predict_fn, *, device, batch_size, data, pp_fn="",
               label_key="label", cache_final=True):
    del cache_final
    super().__init__(device=device, batch_size=batch_size, data=data,
                     pp_fn=pp_fn)
    self.predict_fn = predict_fn
    self.label_key = label_key

  @torch.no_grad()
  def run(self, train_state):
    ncorrect = nloss = nseen = 0.0
    for batch in self.batches():
      mask = batch["_mask"]
      labels = batch[self.label_key]
      logits, *_ = self.predict_fn(train_state, batch)
      logp = torch.log_softmax(logits, dim=-1)
      if labels.ndim == logits.ndim:  # one-hot
        y = torch.argmax(labels, dim=-1)
        xent = -torch.sum(labels * logp, dim=-1)
      else:
        y = labels.long()
        xent = -torch.gather(logp, -1, y[:, None])[:, 0]
      correct = (torch.argmax(logits, dim=-1) == y).float()
      ncorrect += float(torch.sum(correct * mask))
      nloss += float(torch.sum(xent * mask))
      nseen += float(torch.sum(mask))
    ncorrect, nloss, nseen = common.reduce_totals(self, ncorrect, nloss,
                                                  nseen)
    yield "prec@1", common.masked_mean(ncorrect, nseen)
    yield "loss", common.masked_mean(nloss, nseen)
