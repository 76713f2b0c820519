"""Port parity: `utils/windows.py` against small_vision_tpu.utils.windows.

The fake runners replay tests/test_bench_requalify.py's window sets (a
clean set, a contended one followed by a clean one, all contended, a retry
worse than the best) and a few seeded random ones; the port's `requalify`
and `qualified_median` must return exactly what the JAX module returns
(bit-equal floats, the same retries and flags) and call the runner the
same number of times.
"""

import numpy as np
import pytest

from small_vision_tpu.utils import windows as jwindows
from small_vision_tpu_torch.utils import windows

SETS = [
    [[950.0, 953.0, 952.0]],
    [[900.9, 935.5, 957.9], [950.0, 953.0, 952.0]],
    [[800.0, 900.0, 1000.0], [880.0, 900.0, 930.0], [850.0, 900.0, 980.0],
     [840.0, 900.0, 990.0]],
    [[880.0, 900.0, 930.0], [800.0, 900.0, 1000.0], [900.0, 905.0, 903.0]],
    [[0.0, 0.0, 0.0]],
] + [np.random.default_rng(seed).uniform(900, 1000, (5, 3)).tolist()
     for seed in range(4)]


class _Fake:
  """Replays window sets in turn (the last one for ever); counts calls."""

  def __init__(self, sets):
    self.sets = [list(s) for s in sets]
    self.calls = 0

  def __call__(self, n):
    out = self.sets[min(self.calls, len(self.sets) - 1)]
    self.calls += 1
    assert len(out) == n
    return out


@pytest.mark.parametrize("sets", SETS)
@pytest.mark.parametrize("threshold,retries", [(2.0, 3), (5.0, 1), (0.5, 0)])
def test_requalify_matches_jax(sets, threshold, retries):
  got_fake, want_fake = _Fake(sets), _Fake(sets)
  got = windows.requalify(got_fake, 3, threshold, retries)
  want = jwindows.requalify(want_fake, 3, threshold, retries)
  assert got == want
  assert got_fake.calls == want_fake.calls


@pytest.mark.parametrize("sets", SETS[:4])
def test_qualified_median_matches_jax(sets):
  flat = [r for s in sets for r in s]

  def runner():
    state = {"i": 0}

    def one():
      r = flat[min(state["i"], len(flat) - 1)]
      state["i"] += 1
      return r
    return one
  assert windows.qualified_median(runner()) == jwindows.qualified_median(
      runner())


def test_constants_and_spread_match_jax():
  assert windows.SPREAD_THRESHOLD_PCT == jwindows.SPREAD_THRESHOLD_PCT
  assert windows.MAX_REQUALIFY_RETRIES == jwindows.MAX_REQUALIFY_RETRIES
  for s in SETS:
    for rates in s:
      assert windows.spread_pct(rates) == jwindows.spread_pct(rates)
