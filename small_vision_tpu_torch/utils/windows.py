"""Timing windows that defend their median: requalification.

Counterpart of small_vision_tpu/utils/windows.py. One contended window
skews a 3-window median enough to flip a verdict, so a reading of
throughput measures a set of windows, and when the set's spread exceeds
`threshold` percent it measures the set again (at most `max_retries`
times) and keeps the tightest set seen. If no set qualifies the result
says `host_contended` instead of shipping a skewed median.
`chip_smoke.py` reads its end-to-end img/s this way (one window: a timed
run of a few steps, or one sampler call).
"""

import numpy as np

SPREAD_THRESHOLD_PCT = 2.0
MAX_REQUALIFY_RETRIES = 3


def spread_pct(rates) -> float:
  """(max - min) / median as a percentage; 0 for a degenerate set."""
  med = float(np.median(rates))
  return 100.0 * (max(rates) - min(rates)) / med if med else 0.0


def requalify(run_windows, windows, threshold=SPREAD_THRESHOLD_PCT,
              max_retries=MAX_REQUALIFY_RETRIES):
  """Measures window sets with `run_windows(n)` until one has a spread
  below `threshold`, or the retries are spent (keeping the tightest set).

  Returns (rates, info), info = {"requalify_retries": int,
  "host_contended": bool, "discarded_window_sets": [spreads...]}.
  """
  best = run_windows(windows)
  discarded = []
  retries = 0
  while spread_pct(best) > threshold and retries < max_retries:
    retries += 1
    candidate = run_windows(windows)
    if spread_pct(candidate) < spread_pct(best):
      discarded.append(round(spread_pct(best), 2))
      best = candidate
    else:
      discarded.append(round(spread_pct(candidate), 2))
  info = {
      "requalify_retries": retries,
      "host_contended": spread_pct(best) > threshold,
      "discarded_window_sets": discarded,
  }
  return best, info


def qualified_median(run_window, windows=3, threshold=SPREAD_THRESHOLD_PCT,
                     max_retries=MAX_REQUALIFY_RETRIES) -> dict:
  """`requalify` for a unit of work of ONE window: `run_window()` gives
  one rate (e.g. img/s over a timed span). Returns {"median", "windows"
  (each window's rate), "spread_pct"} and the requalification fields."""
  def run_windows(n):
    return [run_window() for _ in range(n)]
  rates, info = requalify(run_windows, windows, threshold, max_retries)
  return {
      "median": float(np.median(rates)),
      "windows": [round(float(r), 3) for r in rates],
      "spread_pct": round(spread_pct(rates), 2),
      **info,
  }
