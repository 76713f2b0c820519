"""Inference-dump evaluator: writes predict_fn inputs+outputs to disk.

Counterpart of small_vision_tpu/evaluators/save.py: the real rows' images
(after the device pp) and the predict_fn's first output go to `outfile` as
`inputs` and `outputs`, every process's rows gathered (in process order)
and written by process 0.
"""

import os

import numpy as np

from small_vision_tpu_torch.evaluators import common


class Evaluator(common.BatchedEvaluator):

  def __init__(self, predict_fn, *, device, batch_size, data, pp_fn="",
               outfile="inference.npz", workdir=None):
    super().__init__(device=device, batch_size=batch_size, data=data,
                     pp_fn=pp_fn)
    self.outfile = os.path.join(workdir or ".", outfile)
    self.predict_fn = predict_fn

  def run(self, train_state):
    ins, outs = [], []
    for batch in self.batches():
      pred, *_ = self.predict_fn(train_state, batch)
      rows = common.gather_rows(self, {"mask": batch["_mask"],
                                       "image": batch["image"], "pred": pred})
      mask = rows["mask"] > 0
      if rows["pred"] is not None:
        outs.append(rows["pred"][mask])
      ins.append(rows["image"][mask])
    if common.is_writer():
      np.savez(self.outfile, inputs=np.concatenate(ins),
               outputs=np.concatenate(outs) if outs else np.zeros(0))
    yield "saved_examples", sum(x.shape[0] for x in ins)
