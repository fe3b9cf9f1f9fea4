"""Rate, latency and spread arithmetic of the benchmark (host clock)."""

from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Optional, Sequence


def rate(done: Sequence[tuple], window_s: float) -> float:
    """Work per second over a window: ``done`` holds ``(end_s, amount)``
    of every piece of work the window completed; the window runs from 0 to
    ``window_s``, the end of the last piece."""
    if window_s <= 0:
        raise ValueError("empty window")
    return sum(a for _, a in done) / window_s


def latencies_ms(requests: Iterable[dict]) -> List[float]:
    """Each request's latency from when it was due (``due``) to when its
    reply was read (``done``), in ms; a request that failed or never
    finished (``done`` None, or ``ok`` false) is infinitely late."""
    out = []
    for r in requests:
        ok = r.get("ok", True) and r.get("done") is not None
        out.append((r["done"] - r["due"]) * 1e3 if ok else math.inf)
    return out


def percentile(values: Sequence[float], p: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``p`` % of
    the sample at or below it."""
    if not values:
        raise ValueError("empty sample")
    s = sorted(values)
    k = max(1, math.ceil(p / 100.0 * len(s)))
    return s[k - 1]


def spread(values: Sequence[float]) -> Optional[float]:
    """Distance between the first and third quartile as a share of the
    median (``statistics.quantiles(values, n=4)``), or None for fewer than
    two values."""
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
