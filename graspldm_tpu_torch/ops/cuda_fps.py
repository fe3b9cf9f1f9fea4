"""Furthest point sampling: the Hopper kernel and its plain version.

``fps_kernel`` (``csrc/fps.cu``) replaces ``graspldm_tpu/ops/pallas_fps.py:
_fps_kernel``, which computes :func:`graspldm_tpu.ops.sampling.
furthest_point_sample`: index 0 first, then M - 1 times the argmax of every
point's running minimum squared distance to the picked set, ties to the
lowest index. What bounds the kernel on the H100 and what its design does
about it is in the notes at the top of the source.

:func:`fps_plain` is the same function in plain PyTorch, the M-step loop of
``sampling.py:39-52``; the distance is ``dx*dx + dy*dy + dz*dz`` left to
right in float32, each a separate elementwise op, the rounding the kernel
reproduces. :func:`fps_apply` runs it for a CPU tensor and launches the
kernel for a CUDA tensor (raising if it cannot); ``FPS_KERNEL.launches``
counts the launches.
"""

from __future__ import annotations

import torch

from ..cuda_build import KernelCounter, on_cuda, ptr, query

__all__ = ["FPS_KERNEL", "fps_plain", "fps_apply"]

FPS_KERNEL = KernelCounter("fps_kernel", "gl_fps")


def fps_plain(coords: torch.Tensor, num_samples: int) -> torch.Tensor:
    """``coords [B, N, 3]`` -> int64 indices ``[B, num_samples]`` (float32 math)."""
    c = coords.float()
    B, N, _ = c.shape
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    rows = torch.arange(B, device=c.device)
    dists = torch.full((B, N), float("inf"), device=c.device)
    out = torch.zeros((B, num_samples), dtype=torch.long, device=c.device)
    last = torch.zeros(B, dtype=torch.long, device=c.device)
    for j in range(1, num_samples):
        dx = x - x[rows, last][:, None]
        dy = y - y[rows, last][:, None]
        dz = z - z[rows, last][:, None]
        dists = torch.minimum(dists, dx * dx + dy * dy + dz * dz)
        last = dists.argmax(dim=1)  # the first maximal index
        out[:, j] = last
    return out


def fps_apply(coords: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Furthest point sampling of ``coords [B, N, 3]``: int64 ``[B, M]``."""
    if coords.ndim != 3 or coords.shape[-1] != 3:
        raise ValueError(f"coords must be [B, N, 3], got {tuple(coords.shape)}")
    if num_samples < 1:
        raise ValueError(f"num_samples must be >= 1, got {num_samples}")
    if not on_cuda(coords):
        return fps_plain(coords, num_samples)
    B, N, _ = coords.shape
    n_max = query("gl_fps_max_points")
    if not 1 <= N <= n_max:
        raise ValueError(f"fps_kernel holds one cloud in one block: N must be in "
                         f"[1, {n_max}], got {N}")
    c = coords.float().contiguous()
    out = torch.empty((B, num_samples), dtype=torch.long, device=c.device)
    FPS_KERNEL(c, ptr(c), ptr(out), B, N, num_samples)
    return out
