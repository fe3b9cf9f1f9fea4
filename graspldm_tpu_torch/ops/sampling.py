"""Point sampling (torch): furthest point sampling (FPS) and gather.

Counterpart of :mod:`graspldm_tpu.ops.sampling`, in its feature-last
layout. FPS goes through its kernel wrapper (:mod:`.cuda_fps`): the plain
version for a CPU tensor, ``fps_kernel`` for a CUDA tensor. Indices are
int64, for torch indexing; their values are the JAX package's.
"""

from __future__ import annotations

import torch

from .cuda_fps import fps_apply as furthest_point_sample

__all__ = ["furthest_point_sample", "gather_points"]


def gather_points(features: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Rows of ``features [B, N, C]`` at ``indices [B, M]`` -> ``[B, M, C]``."""
    return torch.gather(features, 1, indices[..., None].expand(-1, -1, features.shape[-1]))
