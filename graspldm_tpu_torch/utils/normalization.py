"""Normalization contract for point clouds and grasp poses (torch).

Counterpart of :mod:`graspldm_tpu.utils.normalization`: clouds and grasp
translations are centered on the per-object cloud mean and divided by a
fixed translation scale (0.05); MRP components are divided by 0.5.
``unnormalized = normalized * std + mean``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

__all__ = [
    "TRANSLATION_SCALE_FACTOR",
    "ROTATION_SCALE_FACTOR",
    "NormalizationMeta",
    "normalize_pc_and_grasps",
    "unnormalize_grasps",
]

TRANSLATION_SCALE_FACTOR = 0.05
ROTATION_SCALE_FACTOR = 0.5


class NormalizationMeta(NamedTuple):
    """Per-object shift/scale; same fields as the JAX package's meta."""

    pc_mean: torch.Tensor  # [..., 3]
    pc_std: torch.Tensor  # [..., 3]
    grasp_mean: torch.Tensor  # [..., 6]
    grasp_std: torch.Tensor  # [..., 6]


def normalize_pc_and_grasps(
    pc: torch.Tensor, grasps: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, NormalizationMeta]:
    """Center on the cloud mean and apply the fixed scales.

    Args:
        pc: ``[..., N, 3]``; grasps: ``[..., G, 6+]`` (dims past 6 pass through).
    """
    pc_mean = pc.mean(dim=-2)
    pc_n = (pc - pc_mean[..., None, :]) / TRANSLATION_SCALE_FACTOR
    t_n = (grasps[..., :3] - pc_mean[..., None, :]) / TRANSLATION_SCALE_FACTOR
    mrp_n = grasps[..., 3:6] / ROTATION_SCALE_FACTOR
    grasps_n = torch.cat([t_n, mrp_n, grasps[..., 6:]], dim=-1)

    batch = pc_mean.shape[:-1]
    kw = dict(dtype=pc.dtype, device=pc.device)
    grasp_std = torch.tensor(
        [TRANSLATION_SCALE_FACTOR] * 3 + [ROTATION_SCALE_FACTOR] * 3, **kw
    )
    meta = NormalizationMeta(
        pc_mean=pc_mean,
        pc_std=torch.full(batch + (3,), TRANSLATION_SCALE_FACTOR, **kw),
        grasp_mean=torch.cat([pc_mean, torch.zeros_like(pc_mean)], dim=-1),
        grasp_std=grasp_std.expand(batch + (6,)),
    )
    return pc_n, grasps_n, meta


def unnormalize_grasps(grasps_n: torch.Tensor, meta: NormalizationMeta) -> torch.Tensor:
    """Invert the normalization for tmrp rows ``[..., G, 6]``."""
    return grasps_n * meta.grasp_std[..., None, :] + meta.grasp_mean[..., None, :]
