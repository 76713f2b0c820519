"""The evaluators' input pipeline.

Counterpart of small_vision_tpu/data/pipeline.py::make_for_inference in one
process: a finite iterator over a source's ordered examples in batches of a
fixed size, the final short batch padded with zeros, and `_mask` marking
the real rows (1.0) against the padding (0.0). The training pipeline
(host-stage workers, prefetch, mixtures) comes with the data slice; the
train loop reads `data.synthetic.batches`.
"""

import numpy as np

from small_vision_tpu_torch.pp.builder import DevicePP


def make_for_inference(source, pp_spec: str, batch_size: int):
  """(iterate, device_pp, n_steps): `iterate()` yields `n_steps` numpy
  batches {"image", "label", "_id", "_mask"} of `batch_size` rows each;
  `device_pp` is the pp string's device stage, which the caller applies on
  the device (every op the port has is a device op)."""
  device_pp = DevicePP(pp_spec)
  n_local = source.num_examples_per_process
  n_steps = -(-max(n_local, 1) // batch_size)  # ceil

  def iterate():
    index = source.epoch_index(ordered=True)
    for i in range(n_steps):
      idx = index[i * batch_size:(i + 1) * batch_size]
      batch = source.take(idx)
      batch["_id"] = idx.astype(np.int64)
      real = idx.shape[0]
      if real < batch_size:  # zero-pad the final short batch
        batch = {k: np.concatenate(
            [v, np.zeros((batch_size - real,) + v.shape[1:], v.dtype)])
                 for k, v in batch.items()}
      batch["_mask"] = (np.arange(batch_size) < real).astype(np.float32)
      yield batch

  return iterate, device_pp, n_steps
