"""Rate and percentile arithmetic over a window's request log."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between closest
    ranks (numpy's default); inf counts as the largest value."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(done: int, t_start: float, t_last: float) -> float:
    """Work completed over the window from its start to the last reply: all
    the work over all the time, stalls and the drain included."""
    if t_last <= t_start:
        raise ValueError("the window has no length")
    return done / (t_last - t_start)


def latencies(log: Iterable[dict]) -> List[float]:
    """Submit-to-reply seconds of every request; a failed one is inf, so it
    misses any limit and sits at the top of the order."""
    return [r["t_done"] - r["t_submit"] if r["ok"] else math.inf for r in log]
