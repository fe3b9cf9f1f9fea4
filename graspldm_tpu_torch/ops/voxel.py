"""Voxelization / devoxelization ops (torch), deterministic on CUDA.

Counterpart of :mod:`graspldm_tpu.ops.voxel`, with the same feature-last
public layout: features ``[B, N, C]``, grids ``[B, V, C]`` with flat voxel
index ``v = x*r^2 + y*r + z``.

``avg_voxelize`` is the one-hot product the JAX package uses: the one-hot
``[B, V, N]`` matrix is built by a scatter that writes each column once
(no accumulation), and the sums are one batched matmul. No float
``index_add_``/``scatter_add`` atomics, so the result does not depend on
thread timing on the card.
"""

from __future__ import annotations

import torch

__all__ = [
    "normalize_coords_for_voxelization",
    "avg_voxelize",
    "trilinear_devoxelize",
]


def normalize_coords_for_voxelization(
    coords: torch.Tensor, resolution: int, normalize: bool = True, eps: float = 0.0
) -> torch.Tensor:
    """Raw ``[B, N, 3]`` point coords -> continuous voxel coords in ``[0, r-1]``."""
    coords = coords.detach()
    centered = coords - coords.mean(dim=1, keepdim=True)
    if normalize:
        radius = centered.norm(dim=-1, keepdim=True).amax(dim=1, keepdim=True)
        norm_coords = centered / (radius * 2.0 + eps) + 0.5
    else:
        norm_coords = (centered + 1.0) / 2.0
    return (norm_coords * resolution).clamp(0.0, resolution - 1.0)


def _flat_voxel_index(vox: torch.Tensor, r: int) -> torch.Tensor:
    return vox[..., 0] * (r * r) + vox[..., 1] * r + vox[..., 2]


def avg_voxelize(
    features: torch.Tensor, vox_coords: torch.Tensor, resolution: int
) -> torch.Tensor:
    """Scatter-mean ``[B, N, C]`` point features into a ``[B, r^3, C]`` grid.

    Float coords are rounded half-to-even (``torch.round`` matches
    ``jnp.round``). Sums and counts accumulate in float32; empty voxels are 0.
    """
    r = resolution
    B, N, _ = features.shape
    V = r * r * r
    if vox_coords.is_floating_point():
        vox_coords = torch.round(vox_coords)
    flat = _flat_voxel_index(vox_coords.long(), r)  # [B, N]
    onehot = torch.zeros(B, V, N, dtype=torch.float32, device=features.device)
    onehot.scatter_(1, flat[:, None, :], 1.0)
    sums = torch.bmm(onehot, features.float())  # [B, V, C]
    counts = onehot.sum(dim=2)  # [B, V] float32
    return (sums / counts.clamp(min=1.0)[..., None]).to(features.dtype)


def trilinear_devoxelize(
    voxel_features: torch.Tensor, coords: torch.Tensor, resolution: int
) -> torch.Tensor:
    """Trilinear interpolation of ``[B, V, C]`` grids at ``[B, N, 3]`` voxel
    coords; the ``hi`` corner is clamped to ``r-1`` (zero weight there)."""
    r = resolution
    coords = coords.detach()
    lo = torch.floor(coords)
    frac = coords - lo
    lo_i = lo.long()
    hi_i = (lo_i + 1).clamp(max=r - 1)
    C = voxel_features.shape[-1]
    out = None
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                ix = (hi_i if cx else lo_i)[..., 0]
                iy = (hi_i if cy else lo_i)[..., 1]
                iz = (hi_i if cz else lo_i)[..., 2]
                w = (
                    (frac[..., 0] if cx else 1.0 - frac[..., 0])
                    * (frac[..., 1] if cy else 1.0 - frac[..., 1])
                    * (frac[..., 2] if cz else 1.0 - frac[..., 2])
                )
                flat = ix * (r * r) + iy * r + iz  # [B, N]
                corner = torch.gather(
                    voxel_features, 1, flat[..., None].expand(-1, -1, C)
                )
                term = corner * w[..., None].to(voxel_features.dtype)
                out = term if out is None else out + term
    return out
