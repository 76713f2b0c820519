"""First-fit sequence packing for 1-D token streams.

Counterpart of small_vision_tpu/data/sequence_packing.py, numpy only: a
plain-Python generator over example dicts that packs several short
sequences into fixed-length rows, emitting `{key}`, `{key}_seg` (1-based
segment ids) and `{key}_pos` (position within segment), the attention-mask
contract consumers expect. As in the JAX package, no pipeline calls it.
"""

from typing import Dict, Iterator, Sequence

import numpy as np


def pack_examples(examples: Iterator[Dict], keys: Sequence[str],
                  length: int, batch_pack: int = 8) -> Iterator[Dict]:
  """Greedy first-fit packing of token sequences to fixed `length` rows.

  Args:
    examples: iterator of dicts with 1-D integer arrays under `keys`.
    keys: which keys to pack (all packed in lockstep; lengths must agree).
    length: output row length per key.
    batch_pack: how many open rows to first-fit against before flushing.

  Yields dicts with `{k}`, `{k}_seg`, `{k}_pos` arrays of shape (length,).
  """
  open_rows = []  # Each: {"used": int, "parts": [(example, start)], ...}

  def new_row():
    return {"used": 0, "segs": [],
            **{k: np.zeros((length,), np.int32) for k in keys},
            **{f"{k}_seg": np.zeros((length,), np.int32) for k in keys},
            **{f"{k}_pos": np.zeros((length,), np.int32) for k in keys}}

  def emit(row):
    out = {}
    for k in keys:
      out[k] = row[k]
      out[f"{k}_seg"] = row[f"{k}_seg"]
      out[f"{k}_pos"] = row[f"{k}_pos"]
    return out

  for ex in examples:
    lens = {k: len(np.asarray(ex[k]).reshape(-1)) for k in keys}
    n = next(iter(lens.values()))
    assert all(v == n for v in lens.values()), (
        f"pack keys must share length, got {lens}")
    if n > length:
      continue  # Drop over-long examples (reference drops too).

    placed = False
    for row in open_rows:
      if row["used"] + n <= length:
        seg_id = len(row["segs"]) + 1
        start = row["used"]
        for k in keys:
          vals = np.asarray(ex[k], np.int32).reshape(-1)
          row[k][start:start + n] = vals
          row[f"{k}_seg"][start:start + n] = seg_id
          row[f"{k}_pos"][start:start + n] = np.arange(n)
        row["used"] += n
        row["segs"].append(seg_id)
        placed = True
        break
    if not placed:
      row = new_row()
      for k in keys:
        vals = np.asarray(ex[k], np.int32).reshape(-1)
        row[k][:n] = vals
        row[f"{k}_seg"][:n] = 1
        row[f"{k}_pos"][:n] = np.arange(n)
      row["used"] = n
      row["segs"] = [1]
      open_rows.append(row)

    # Flush full-enough rows once the pool is saturated.
    while len(open_rows) > batch_pack:
      yield emit(open_rows.pop(0))

  for row in open_rows:
    yield emit(row)
