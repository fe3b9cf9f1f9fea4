"""The numbers that decide ``correct``, each against its limit.

The program's outputs for the checked rows against the reference's:

* ``tmrp_err``: the largest gap of a grasp's translation and MRP, each
  divided by its normalisation scale (0.05 m, 0.5), so in the units the
  decoder outputs;
* ``pose_err``: the largest gap of an entry of the 4x4 pose;
* ``conf_err``: the largest gap of a success confidence.

The limits live in ``portbench/limits/<workload>.json``; ``PERF.md`` gives
the readings each was set from. A number that is not finite fails.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

GRASP_STD = np.array([0.05] * 3 + [0.5] * 3)


def numbers(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]) -> Dict[str, float]:
    """``got`` / ``want``: ``grasp_tmrp [R, 6]``, ``grasps [R, 4, 4]``,
    ``confidence [R]`` of the same rows."""
    def gap(k, scale=1.0):
        d = np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64)) / scale
        return float(d.max(initial=0.0)) if np.isfinite(d).all() else math.inf

    return {"tmrp_err": gap("grasp_tmrp", GRASP_STD), "pose_err": gap("grasps"),
            "conf_err": gap("confidence")}


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> List[dict]:
    """One ``{name, value, limit, ok}`` per limit; a missing number fails."""
    out = []
    for name, limit in limits.items():
        v = values.get(name, math.inf)
        out.append({"name": name, "value": v, "limit": limit, "ok": bool(v <= limit)})
    return out
