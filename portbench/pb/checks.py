"""Structural checks of generated grasps (frozen copy of
``chip_smoke.py:check_grasps`` / ``check_poses``), as numpy functions that
return what is wrong instead of raising."""

from __future__ import annotations

from typing import List

import numpy as np

# |R R^T - I| and |det R - 1| of a pose built from an MRP in float32
ORTHONORMAL_TOL = 1e-4


def grasp_faults(out: dict, b: int, g: int) -> List[str]:
    """Shapes and finiteness of one call's ``grasps [b, g, 4, 4]``,
    ``grasp_tmrp [b, g, 6]`` and ``confidence [b, g]``."""
    want = {"grasps": (b, g, 4, 4), "grasp_tmrp": (b, g, 6), "confidence": (b, g)}
    faults = []
    for k, shape in want.items():
        if k not in out:
            faults.append(f"{k} missing")
            continue
        v = np.asarray(out[k])
        if v.shape != shape:
            faults.append(f"{k} shape {v.shape} != {shape}")
        elif not np.isfinite(v).all():
            faults.append(f"{k} has non-finite values")
    return faults


def pose_faults(H: np.ndarray) -> List[str]:
    """Every pose of ``H [..., 4, 4]``: an orthonormal rotation block with
    det +1 and the bottom row [0, 0, 0, 1]."""
    H = np.asarray(H, np.float64)
    R = H[..., :3, :3]
    ortho = np.abs(R @ np.swapaxes(R, -1, -2) - np.eye(3)).max(initial=0.0)
    det = np.abs(np.linalg.det(R) - 1.0).max(initial=0.0)
    bottom = np.abs(H[..., 3, :] - np.array([0, 0, 0, 1.0])).max(initial=0.0)
    faults = []
    if not ortho <= ORTHONORMAL_TOL or not det <= ORTHONORMAL_TOL:
        faults.append(f"rotation blocks not orthonormal (|RR^T - I| {ortho:.2e}, "
                      f"|det R - 1| {det:.2e})")
    if bottom != 0.0:
        faults.append(f"bottom row off by {bottom:.2e}")
    return faults
