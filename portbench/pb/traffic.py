"""The one traffic generator: turns a mix's parameters
(``portbench/traffic/<mix>.json``) and a seed into a run's inputs.

The mix's ``rig`` (``portbench/rigs/<rig>.py``) says how the window
drives the program; this module makes what it sends:

* a batch mix (``rig`` "batch"): call ``i``'s ``clouds_per_call`` clouds
  of ``points`` points (``clouds`` "full" or "partial");
* a serve mix (``rig`` "serve"): the window's requests, at a mean of
  ``rate_per_s`` for the window's length under the arrival law
  ``arrivals`` (``portbench/arrivals/<law>.py``), each one cloud of
  ``points_min`` to ``points_max`` points (log-uniform).

Every seed gets the same set of sizes and gaps, in another order: the
sizes are the quantiles of the log-uniform distribution and the gaps the
law's, shuffled by the seed. So two seeds offer the same work and the
same load, and the seed changes only which cloud comes when.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from . import spec
from .clouds import clouds, rng_for


def derived_seed(seed: int, stream: str, index: int) -> int:
    """A 63-bit seed for a ``torch.Generator``, independent per stream and index."""
    s = rng_for(seed, stream, index).integers(0, 2 ** 63 - 1)
    return int(s)


def call_clouds(mix: dict, seed: int, i: int) -> np.ndarray:
    """Call ``i``'s ``[clouds_per_call, points, 3]`` metric clouds (``i < 0``:
    the warm-up's)."""
    stream = "warm" if i < 0 else "call"
    return clouds(mix["clouds"], rng_for(seed, stream, abs(i)), mix["clouds_per_call"],
                  mix["points"])


def _quantiles(k: int) -> np.ndarray:
    return (np.arange(k) + 0.5) / k


def serve_schedule(mix: dict, seed: int, seconds: float, root=spec.ROOT) -> List[dict]:
    """The window's requests in arrival order: ``due`` (s after the window
    opens) and ``points``."""
    k = max(1, int(round(mix["rate_per_s"] * seconds)))
    u = _quantiles(k)
    lo, hi = math.log(mix["points_min"]), math.log(mix["points_max"])
    sizes = np.rint(np.exp(lo + u * (hi - lo))).astype(int)
    order = rng_for(seed, "order", 0)
    sizes = order.permutation(sizes)
    gaps = spec.plugin("arrivals", mix["arrivals"], root).gaps(mix, k, order)
    due = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    return [{"due": float(d), "points": int(n)} for d, n in zip(due, sizes)]


def request_cloud(mix: dict, seed: int, k: int, points: int) -> np.ndarray:
    """Request ``k``'s ``[points, 3]`` cloud (``k < 0``: a warm-up request's)."""
    stream = "warmreq" if k < 0 else "request"
    return clouds(mix["clouds"], rng_for(seed, stream, abs(k)), 1, points)[0]
