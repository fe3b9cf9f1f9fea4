"""Plain float32 reference of generation: clouds -> 4x4 grasp poses.

Recomputes everything the program derives: the per-object normalisation,
the encoding, the sampler's schedule and steps (``samplers/<name>.py``,
handed in by the caller), the decoder, the unnormalisation, the MRP ->
rotation conversion and the sigmoid. Runs wherever its inputs live; TF32
must be off (the caller sets it).
"""

from __future__ import annotations

import torch

from .model import GraspCVAE

TRANSLATION_SCALE = 0.05
ROTATION_SCALE = 0.5
GRASP_STD = (TRANSLATION_SCALE,) * 3 + (ROTATION_SCALE,) * 3


def normalize(pc: torch.Tensor):
    """``[B, N, 3]`` metric clouds -> (centred clouds / 0.05, means ``[B, 3]``)."""
    mean = pc.mean(dim=-2)
    return (pc - mean[:, None, :]) / TRANSLATION_SCALE, mean


def mrp_to_rotmat(p: torch.Tensor) -> torch.Tensor:
    """Modified Rodrigues parameters ``[..., 3]`` -> ``[..., 3, 3]``."""
    m = (p * p).sum(-1, keepdim=True)
    qv = 2.0 * p / (1.0 + m)
    qw = ((1.0 - m) / (1.0 + m))[..., 0]
    x, y, z = qv.unbind(-1)
    xx, yy, zz, ww = x * x, y * y, z * z, qw * qw
    rows = [
        torch.stack([xx - yy - zz + ww, 2 * (x * y - z * qw), 2 * (x * z + y * qw)], -1),
        torch.stack([2 * (x * y + z * qw), -xx + yy - zz + ww, 2 * (y * z - x * qw)], -1),
        torch.stack([2 * (x * z - y * qw), 2 * (y * z + x * qw), -xx - yy + zz + ww], -1),
    ]
    return torch.stack(rows, dim=-2)


def poses(tmrp: torch.Tensor) -> torch.Tensor:
    """``[..., 6]`` (translation, MRP) -> ``[..., 4, 4]``."""
    H = torch.zeros(tmrp.shape[:-1] + (4, 4), dtype=tmrp.dtype, device=tmrp.device)
    H[..., :3, :3] = mrp_to_rotmat(tmrp[..., 3:6])
    H[..., :3, 3] = tmrp[..., :3]
    H[..., 3, 3] = 1.0
    return H


@torch.no_grad()
def encode(vae: GraspCVAE, pc: torch.Tensor):
    """A batch of clouds ``[B, N, 3]``, normalised and encoded together as
    it is served -> (``z_pc [B, Ce, D]``, cloud means ``[B, 3]``)."""
    pc_n, mean = normalize(pc)
    return vae.encode_pc(pc_n), mean


@torch.no_grad()
def from_latents(vae: GraspCVAE, ddm, cfg: dict, z_pc: torch.Tensor, mean: torch.Tensor,
                 latents: torch.Tensor, steps: int = 0, sampler=None, noise=None,
                 block: int = 8192) -> dict:
    """Rows of grasps from their clouds' ``z_pc [R, Ce, D]`` and means
    ``[R, 3]`` and their starting latents ``[R, L]``: x_T for ``sampler``
    (a module of ``samplers/``; ``ddm`` given, ``steps`` steps, its
    ``noise [draws, R, L]`` where it draws), or the VAE prior's z_h (``ddm``
    None). Returns float32 ``grasp_tmrp [R, 6]``, ``grasps [R, 4, 4]`` and
    ``confidence [R]``."""
    tmrp, logit = [], []
    for s in range(0, latents.shape[0], block):
        z, lat = z_pc[s:s + block], latents[s:s + block]
        if ddm is not None:
            lat = sampler.sample(ddm, cfg, lat, z, steps,
                                 None if noise is None else noise[:, s:s + block])
        t, c = vae.decode(lat, z)
        tmrp.append(t)
        logit.append(c[:, 0])
    std = torch.tensor(GRASP_STD, device=latents.device)
    tmrp_w = torch.cat(tmrp) * std + torch.cat([mean, torch.zeros_like(mean)], dim=-1)
    return {"grasp_tmrp": tmrp_w, "grasps": poses(tmrp_w),
            "confidence": torch.sigmoid(torch.cat(logit))}


def generate(vae: GraspCVAE, ddm, cfg: dict, pc: torch.Tensor, grasps: int,
             rows: torch.Tensor, latents: torch.Tensor, steps: int = 0, sampler=None,
             noise=None) -> dict:
    """The outputs of ``rows`` (indices into the ``B * grasps`` rows of
    ``pc [B, N, 3]``; cloud ``row // grasps``) from their starting latents
    ``latents [len(rows), L]`` (see :func:`from_latents`)."""
    z_pc, mean = encode(vae, pc)
    obj = rows // grasps
    return from_latents(vae, ddm, cfg, z_pc[obj], mean[obj], latents, steps, sampler, noise)
