"""Port parity: `data.sequence_packing.pack_examples` against the JAX
package's on seeded streams of varied lengths (over-long examples among
them, which both drop), one key or several packed in lockstep, and
`batch_pack` 1 and 8. The rows must be equal arrays, in the same order.
"""

import numpy as np
import pytest

from small_vision_tpu.data import sequence_packing as jsp
from small_vision_tpu_torch.data import sequence_packing as tsp


def _stream(seed, n, keys, length):
  """n examples, lengths 1 .. length + 4 (a few over `length`), the same
  length under every key."""
  rng = np.random.default_rng(seed)
  for _ in range(n):
    m = int(rng.integers(1, length + 5))
    yield {k: rng.integers(0, 1000, m, dtype=np.int64) for k in keys}


@pytest.mark.parametrize("batch_pack", [1, 8])
@pytest.mark.parametrize("keys,length", [(("tokens",), 16),
                                         (("tokens", "labels"), 24)])
@pytest.mark.parametrize("seed", [0, 1])
def test_pack_examples_matches_jax(seed, keys, length, batch_pack):
  want = list(jsp.pack_examples(_stream(seed, 120, keys, length), keys,
                                length, batch_pack))
  got = list(tsp.pack_examples(_stream(seed, 120, keys, length), keys,
                               length, batch_pack))
  assert len(got) == len(want) > 10
  for g, w in zip(got, want):
    assert set(g) == set(w) == {f"{k}{s}" for k in keys
                               for s in ("", "_seg", "_pos")}
    for name in w:
      assert g[name].dtype == w[name].dtype == np.int32
      np.testing.assert_array_equal(g[name], w[name], err_msg=name)


def test_over_long_examples_are_dropped_and_keys_must_agree():
  rows = list(tsp.pack_examples(
      iter([{"t": np.arange(9)}, {"t": np.arange(3)}]), ["t"], 8))
  assert len(rows) == 1
  np.testing.assert_array_equal(rows[0]["t"][:3], [0, 1, 2])
  np.testing.assert_array_equal(rows[0]["t_seg"], [1, 1, 1, 0, 0, 0, 0, 0])
  with pytest.raises(AssertionError, match="share length"):
    list(tsp.pack_examples(iter([{"a": np.arange(3), "b": np.arange(2)}]),
                           ["a", "b"], 8))
