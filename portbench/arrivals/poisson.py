"""Poisson arrivals at the mix's ``rate_per_s``: the gaps are the
quantiles of the exponential distribution at that rate, in the order the
seed's generator shuffles them.

An arrival law is found by the mix's ``arrivals`` name and gives
``gaps(mix, k, rng)``: the ``k`` gaps in seconds between one request and
the next (the last unused), the same set for every seed, in an order drawn
from ``rng``, with a mean near ``1 / rate_per_s``.
"""

import numpy as np


def quantiles(k: int) -> np.ndarray:
    return (np.arange(k) + 0.5) / k


def gaps(mix: dict, k: int, rng: np.random.Generator) -> np.ndarray:
    return rng.permutation(-np.log1p(-quantiles(k)) / mix["rate_per_s"])
