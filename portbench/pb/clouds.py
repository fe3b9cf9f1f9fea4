"""Seeded synthetic point clouds (frozen copy of ``chip_smoke.py:clouds``,
with a partial-view cut).

A cloud is the noisy surface of a 4 x 3 x 8 cm box around a random centre
within 30 cm of the origin, in metres, float32. A full cloud samples every
face; a partial view keeps the faces that face a random camera direction,
one face per axis, as a depth camera would see a box.
"""

from __future__ import annotations

import numpy as np

BOX_HALF_EXTENT = np.array([0.04, 0.03, 0.08])
NOISE_M = 0.001
CENTRE_RANGE_M = 0.3


def rng_for(seed: int, stream: str, index: int) -> np.random.Generator:
    """An independent generator for item ``index`` of ``stream`` under ``seed``."""
    return np.random.default_rng([abs(int(seed)), _stream_id(stream), int(index) + 1])


def _stream_id(stream: str) -> int:
    return int.from_bytes(stream.encode()[:8].ljust(8, b"\0"), "little")


def full_clouds(rng: np.random.Generator, b: int, n: int) -> np.ndarray:
    """``[b, n, 3]``: points on every face of the box."""
    pts = rng.uniform(-1.0, 1.0, size=(b, n, 3))
    axis = rng.integers(0, 3, size=(b, n))
    np.put_along_axis(pts, axis[..., None], np.sign(rng.uniform(-1, 1, (b, n, 1))), axis=-1)
    pts = pts * BOX_HALF_EXTENT + rng.normal(0.0, NOISE_M, size=pts.shape)
    return (pts + rng.uniform(-CENTRE_RANGE_M, CENTRE_RANGE_M, size=(b, 1, 3))).astype(np.float32)


def partial_view(rng: np.random.Generator, n: int) -> np.ndarray:
    """``[n, 3]``: points on the three faces that face a random camera."""
    cam = rng.normal(size=3)
    facing = np.where(cam >= 0.0, 1.0, -1.0)
    pts = rng.uniform(-1.0, 1.0, size=(n, 3))
    axis = rng.integers(0, 3, size=n)
    pts[np.arange(n), axis] = facing[axis]
    pts = pts * BOX_HALF_EXTENT + rng.normal(0.0, NOISE_M, size=pts.shape)
    return (pts + rng.uniform(-CENTRE_RANGE_M, CENTRE_RANGE_M, size=(1, 3))).astype(np.float32)


def clouds(kind: str, rng: np.random.Generator, b: int, n: int) -> np.ndarray:
    """``[b, n, 3]`` clouds of ``kind`` "full" or "partial"."""
    if kind == "full":
        return full_clouds(rng, b, n)
    if kind == "partial":
        return np.stack([partial_view(rng, n) for _ in range(b)])
    raise ValueError(f"unknown cloud kind {kind!r}")
