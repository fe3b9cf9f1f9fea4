"""Class- and region-conditioned latent denoisers (torch).

Counterpart of :mod:`graspldm_tpu.models.conditioning`. Each is the
denoiser of :class:`.grasp_ldm.GraspLatentDDM` with one more embedding,
constant across sampler steps, added to the time embedding before the
broadcast over the conditioning channels:

* class: ``silu(Dense(1 -> emb)(cls))`` of a scalar label per row
  (``cls_embed``);
* region: ``silu(max_P(Dense(silu(Dense(pts)))))`` over the region's points
  ``[B, P, 3]``, a shared-MLP PointNet of hidden width ``region_hidden``
  (``region_mlp_1``, ``region_mlp_2``).

``cond_mask [B]`` (1 keep, 0 drop) zeroes that embedding per row: the null
condition of classifier-free guidance. The parameter names are the flax
modules', so :mod:`..utils.convert` carries the weights across.

Like the JAX modules, these have no ``dtype``: the generation kernels run a
conditioned denoiser in float32 even in a bf16 flagship, whose decoder
alone keeps the declared compute dtype (``graspldm_tpu/flagship.py``
passes ``dtype`` only to the unconditional denoiser).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .grasp_ldm import GraspLatentDDM

__all__ = ["ClassConditionedGraspLatentDDM", "RegionConditionedGraspLatentDDM"]


def _masked(emb: torch.Tensor, cond_mask: Optional[torch.Tensor]) -> torch.Tensor:
    if cond_mask is None:
        return emb
    return emb * cond_mask.reshape(-1, 1).to(emb.dtype)


class _ConditionedDDM(GraspLatentDDM):
    def __init__(self, latent_in_features: int = 4, pc_latent_size: int = 64,
                 block_channels: Sequence[int] = (32, 64, 128, 256),
                 resnet_block_groups: int = 4, dropout: Optional[float] = 0.1,
                 random_fourier_features: bool = True, learned_sinusoidal_dim: int = 16):
        super().__init__(latent_in_features, pc_latent_size, block_channels,
                         resnet_block_groups, dropout, random_fourier_features,
                         learned_sinusoidal_dim, dtype=None)


class ClassConditionedGraspLatentDDM(_ConditionedDDM):
    """``(x [B,1,D], t [B], z_cond [B, C_pc, D_pc], cls_cond [B], cond_mask)
    -> eps [B, 1, D]``."""

    conditioning = "class"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.cls_embed = nn.Linear(1, self.latent_in_features * 4)

    def extra_emb(self, cls_cond: torch.Tensor,
                  cond_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cls = cls_cond.reshape(-1, 1).to(self.cls_embed.weight.dtype)
        return _masked(F.silu(self.cls_embed(cls)), cond_mask)

    def forward(self, x, time, z_cond=None, cls_cond=None, cond_mask=None):
        if cls_cond is None:
            raise ValueError("class-conditioned denoiser: cls_cond is required")
        return super().forward(x, time, z_cond, extra_emb=self.extra_emb(cls_cond, cond_mask))


class RegionConditionedGraspLatentDDM(_ConditionedDDM):
    """``(x [B,1,D], t [B], z_cond, region_points [B, P, 3], cond_mask) ->
    eps [B, 1, D]``."""

    conditioning = "region"
    region_hidden = 64

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.region_mlp_1 = nn.Linear(3, self.region_hidden)
        self.region_mlp_2 = nn.Linear(self.region_hidden, self.latent_in_features * 4)

    def extra_emb(self, region_points: torch.Tensor,
                  cond_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = F.silu(self.region_mlp_1(region_points.to(self.region_mlp_1.weight.dtype)))
        return _masked(F.silu(self.region_mlp_2(h).amax(dim=-2)), cond_mask)

    def forward(self, x, time, z_cond=None, region_points=None, cond_mask=None):
        if region_points is None:
            raise ValueError("region-conditioned denoiser: region_points is required")
        return super().forward(x, time, z_cond,
                               extra_emb=self.extra_emb(region_points, cond_mask))
