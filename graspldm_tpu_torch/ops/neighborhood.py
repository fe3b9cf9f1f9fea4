"""Neighborhood ops (torch): ball query, grouping, 3-NN interpolation.

Counterpart of :mod:`graspldm_tpu.ops.neighborhood`, in its feature-last
layout, as plain PyTorch (the JAX package has no kernel here either): the
dense ``[B, M, N]`` formulation, no atomics, indices int64 with the JAX
package's values. The selections are discrete, so each is written to give
JAX's indices on equal inputs: the radius test uses exact per-pair
differences and ``radius * radius`` in float32, and the 3-NN picks the
three smallest distances with a stable sort, lower index first on ties, as
``lax.top_k`` does (``torch.topk`` promises no order among ties).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["pairwise_sq_dists", "ball_query", "group_points", "three_nn", "three_nn_interpolate"]

# Above this many live float32 elements of the [B, M, N, 3] difference
# tensor, ball_query runs over blocks of M (the JAX package's threshold).
_BALL_QUERY_BLOCK_THRESHOLD = 64 * 1024 * 1024


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances ``[B, M, N]`` between ``a [B, M, 3]`` and ``b [B, N, 3]``
    by the ``|a|^2 - 2ab + |b|^2`` expansion, clamped at 0."""
    a2 = (a * a).sum(-1, keepdim=True)
    b2 = (b * b).sum(-1)[:, None, :]
    return (a2 - 2.0 * torch.bmm(a, b.transpose(1, 2)) + b2).clamp(min=0.0)


def _ball_query_block(centers: torch.Tensor, points: torch.Tensor, r2: torch.Tensor,
                      U: int) -> torch.Tensor:
    """Ball query of ``centers [B, Mb, 3]``: exact per-pair distances (the
    expansion's rounding would flip borderline inclusions)."""
    N = points.shape[1]
    diff = centers[:, :, None, :] - points[:, None, :, :]  # [B, Mb, N, 3]
    dx, dy, dz = diff.unbind(-1)
    mask = dx * dx + dy * dy + dz * dz < r2
    idx = torch.arange(N, device=points.device)
    key = torch.where(mask, idx, N).sort(dim=-1).values[..., :U]  # first U in index order
    count = mask.sum(-1, keepdim=True)
    first = torch.where(count > 0, key[..., :1], 0)
    slot = torch.arange(U, device=points.device)
    return torch.where(slot < count, key, first)


def ball_query(centers: torch.Tensor, points: torch.Tensor, radius: float,
               num_neighbors: int, block_size: Optional[int] = None) -> torch.Tensor:
    """Indices ``[B, M, U]`` of up to U points of ``points [B, N, 3]`` within
    ``radius`` of each of ``centers [B, M, 3]``: the first U in index order,
    the remaining slots padded with the first found, 0 if none is found.

    Above the JAX package's memory threshold (or given ``block_size``) the
    M axis runs in blocks; the selection is per centre, so the result is
    the same."""
    B, M, _ = centers.shape
    N = points.shape[1]
    r = torch.tensor(radius, dtype=torch.float32, device=points.device)
    r2 = r * r  # in float32, as the traced radius squares in JAX
    if block_size is None:
        if B * M * N * 3 <= _BALL_QUERY_BLOCK_THRESHOLD:
            return _ball_query_block(centers, points, r2, num_neighbors)
        block_size = max(1, _BALL_QUERY_BLOCK_THRESHOLD // (B * N * 3))
        block_size = 1 << (block_size.bit_length() - 1)
    return torch.cat([_ball_query_block(centers[:, s:s + block_size], points, r2, num_neighbors)
                      for s in range(0, M, block_size)], dim=1)


def group_points(features: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Neighbourhoods: ``features [B, N, C]`` at ``indices [B, M, U]`` -> ``[B, M, U, C]``."""
    B, M, U = indices.shape
    C = features.shape[-1]
    flat = indices.reshape(B, M * U, 1).expand(-1, -1, C)
    return torch.gather(features, 1, flat).reshape(B, M, U, C)


def three_nn(points: torch.Tensor, centers: torch.Tensor):
    """The 3 nearest of ``centers [B, M, 3]`` to each of ``points [B, N, 3]``:
    (squared distances clamped to ``[1e-10, 1e10]``, indices), each
    ``[B, N, 3]``, nearest first, the lower index first on ties."""
    d2, idx = pairwise_sq_dists(points, centers).sort(dim=-1, stable=True)
    return d2[..., :3].clamp(1e-10, 1e10), idx[..., :3]


def three_nn_interpolate(points: torch.Tensor, centers: torch.Tensor,
                         center_features: torch.Tensor) -> torch.Tensor:
    """Inverse-squared-distance weighted 3-NN interpolation of
    ``center_features [B, M, C]`` at ``points [B, N, 3]`` -> ``[B, N, C]``:
    weights ``w_i = prod_{j!=i} d_j / sum_k prod_{j!=k} d_j`` over the
    :func:`three_nn` distances."""
    d, idx = three_nn(points, centers)
    d0, d1, d2_ = d.unbind(-1)
    denom = d0 * d1 + d0 * d2_ + d1 * d2_
    w = torch.stack([d1 * d2_, d0 * d2_, d0 * d1], dim=-1) / denom[..., None]
    feats = group_points(center_features, idx)  # [B, N, 3, C]
    return (feats * w[..., None].to(feats.dtype)).sum(dim=2)
