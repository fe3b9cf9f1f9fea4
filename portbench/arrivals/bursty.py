"""Bursts at the mix's mean ``rate_per_s``: ``burst`` requests at once
(``burst_gap_s`` apart, 0 by default), the bursts themselves Poisson at
``rate_per_s / burst``. The burst gaps are the exponential distribution's
quantiles, shuffled by the seed (see ``poisson.py`` for what a law gives)."""

import numpy as np


def gaps(mix: dict, k: int, rng: np.random.Generator) -> np.ndarray:
    m = int(mix["burst"])
    inner = float(mix.get("burst_gap_s", 0.0))
    n = -(-k // m)
    u = (np.arange(n) + 0.5) / n
    between = rng.permutation(-np.log1p(-u) * m / mix["rate_per_s"])
    out = np.full(k, inner)
    ends = np.arange(m - 1, k, m)
    out[ends] = np.maximum(between[:len(ends)] - inner * (m - 1), 0.0)
    return out
