"""The two-window-slope timing discipline, the port's own copy of the
repository's ``bench_timing.two_window_slope``.

Each window ends in a readback that waits for the card; timing two
window lengths with matched min-of-k reps and differencing cancels that
fixed cost: the slope is the steady-state time of one step.
"""
from __future__ import annotations

__all__ = ["two_window_slope"]


def two_window_slope(window, n_long, n_short, reps=3):
    """Run ``window(n)`` (returning wall seconds for n steps, ending in a
    real completion barrier) at two lengths, matched ``reps`` each.

    Returns a dict:
      dt, n_slope    — differenced time over differenced step count
                       (falls back to the raw long window when
                       degenerate, with timing="raw_window")
      timing         — "two_window_slope" | "raw_window"
      longs, shorts  — every rep
      fixed_cost_s   — the per-window fixed cost the slope cancelled
      pair_dts       — positive (long, short) rep differences, sorted
    """
    longs = [window(n_long) for _ in range(reps)]
    shorts = [window(n_short) for _ in range(reps)]
    t_long, t_short = min(longs), min(shorts)
    dt, n_slope, timing = t_long - t_short, n_long - n_short, \
        "two_window_slope"
    if n_slope <= 0 or dt <= 0:
        dt, n_slope, timing = t_long, n_long, "raw_window"
    frac = 1.0 - float(n_short) / n_long if n_long else 0.0
    fixed = (t_short - t_long * n_short / n_long) / frac \
        if timing == "two_window_slope" and frac > 1e-9 else 0.0
    pair_dts = sorted(tl - ts for tl in longs for ts in shorts
                      if tl > ts)
    return {"dt": dt, "n_slope": n_slope, "timing": timing,
            "longs": longs, "shorts": shorts, "fixed_cost_s": fixed,
            "pair_dts": pair_dts}
