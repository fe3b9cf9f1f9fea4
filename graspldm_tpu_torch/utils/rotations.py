"""Batched MRP / quaternion / rotation-matrix conversions (torch).

Counterpart of :mod:`graspldm_tpu.utils.rotations` for the conversions the
generation path uses. Conventions are identical: quaternions are ``xyzw``,
MRP ``p = q_vec / (1 + q_w)``, tmrp layout is ``[t(3), mrp(3)]``.
"""

from __future__ import annotations

import torch

__all__ = ["mrp_to_quat", "quat_to_rotmat", "mrp_to_rotmat", "Rt_to_H", "tmrp_to_H"]


def mrp_to_quat(mrp: torch.Tensor) -> torch.Tensor:
    """MRP ``[..., 3]`` -> quaternion ``[..., 4]`` (xyzw)."""
    magsq = (mrp * mrp).sum(-1, keepdim=True)
    qvec = 2.0 * mrp / (1.0 + magsq)
    qw = (1.0 - magsq) / (1.0 + magsq)
    return torch.cat([qvec, qw], dim=-1)


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """Unit quaternions ``[..., 4]`` (xyzw) -> rotation matrices ``[..., 3, 3]``.

    No normalization is applied, as in the JAX package.
    """
    x, y, z, w = quat.unbind(-1)
    x2, y2, z2, w2 = x * x, y * y, z * z, w * w
    xy, zw, xz, yw, yz, xw = x * y, z * w, x * z, y * w, y * z, x * w
    rows = [
        torch.stack([x2 - y2 - z2 + w2, 2.0 * (xy - zw), 2.0 * (xz + yw)], -1),
        torch.stack([2.0 * (xy + zw), -x2 + y2 - z2 + w2, 2.0 * (yz - xw)], -1),
        torch.stack([2.0 * (xz - yw), 2.0 * (yz + xw), -x2 - y2 + z2 + w2], -1),
    ]
    return torch.stack(rows, dim=-2)


def mrp_to_rotmat(mrp: torch.Tensor) -> torch.Tensor:
    return quat_to_rotmat(mrp_to_quat(mrp))


def Rt_to_H(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Rotation ``[..., 3, 3]`` + translation ``[..., 3]`` -> ``[..., 4, 4]``."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def tmrp_to_H(tmrp: torch.Tensor) -> torch.Tensor:
    """``[..., 6]`` (t first, then mrp) -> ``[..., 4, 4]``."""
    return Rt_to_H(mrp_to_rotmat(tmrp[..., 3:6]), tmrp[..., :3])
