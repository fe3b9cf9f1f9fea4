"""Host-side point-count regularization for serving requests.

A copy of :func:`graspldm_tpu.utils.pointcloud_helpers.regularize_pc_point_count`
without its furthest-point option: importing the JAX package's ``utils``
loads JAX through the sub-package ``__init__``, which the port must not.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["regularize_pc_point_count"]


def regularize_pc_point_count(
    pc: np.ndarray, num_points: int, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Resize a cloud to exactly ``num_points`` (subsample or pad-by-resample)."""
    rng = rng or np.random.default_rng()
    n = len(pc)
    if n == num_points:
        return pc
    if n > num_points:
        return pc[rng.choice(n, num_points, replace=False)]
    extra = rng.choice(n, num_points - n, replace=True)
    return np.concatenate([pc, pc[extra]], axis=0)
