"""The window's arithmetic: rates over the window, tails over all requests,
busy time as the union of device intervals. Percentiles interpolate
linearly between order statistics, as ``numpy.percentile`` does (a copy of
the arithmetic of the program's latency recorder)."""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np


def percentile(values: Sequence[float], q: float) -> float:
    if not len(values):
        raise ValueError("a percentile of no values")
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def rate(count: float, window_s: float) -> float:
    """Work over the whole window's seconds."""
    if window_s <= 0:
        raise ValueError(f"a window of {window_s} s")
    return count / window_s


def busy_union(spans: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + ((cur_e - cur_s) if cur_e is not None else 0.0)


def idle_gaps(spans: Iterable[Tuple[float, float]], start: float, end: float
              ) -> List[Tuple[float, float]]:
    """The (start, end) stretches of [start, end] that no interval covers."""
    gaps, cur = [], start
    for s, e in sorted(spans):
        if s > cur:
            gaps.append((cur, min(s, end)))
        cur = max(cur, e)
        if cur >= end:
            break
    if cur < end:
        gaps.append((cur, end))
    return [g for g in gaps if g[1] > g[0]]


def idle_share(busy_s: float, window_s: float) -> float:
    return 1.0 - busy_s / window_s
