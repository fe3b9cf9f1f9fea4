"""Latent diffusion denoiser over grasp latents (torch).

Counterpart of :class:`graspldm_tpu.models.grasp_ldm.GraspLatentDDM`. The
public latent layout ``[B, 1, D]`` is already the channel-first
``[B, C=1, L=D]`` layout of the torch ResNet core, so no transpose is
needed (the JAX module transposes to ``[B, L=D, C=1]`` internally). The
module is the denoiser itself, so its ``state_dict`` is the bare denoiser
key space :func:`graspldm_tpu.utils.torch_convert.grasp_ldm_variables_from_torch`
accepts.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .resnet1d import TimeConditionedResNet1D

__all__ = ["GraspLatentDDM"]


class GraspLatentDDM(TimeConditionedResNet1D):
    """Conditional epsilon-prediction denoiser ``(x [B,1,D], t [B],
    z_cond [B, C_pc, D_pc]) -> eps [B, 1, D]``.

    ``dtype`` is the declared compute dtype (``None`` = float32) of the
    generation kernels and of ``forward(..., dtype=ddm.dtype)``, which the
    plain-module generation route calls; without it ``forward`` runs in
    the parameter dtype. ``learned_sinusoidal_cond`` (with
    ``random_fourier_features=False``) learns the Fourier time features.
    ``conditioning`` names the extra condition a subclass takes
    (:mod:`.conditioning`); None here.
    """

    conditioning = None

    def __init__(self, latent_in_features: int = 4, pc_latent_size: int = 64,
                 block_channels: Sequence[int] = (32, 64, 128, 256),
                 resnet_block_groups: int = 4, dropout: Optional[float] = 0.1,
                 random_fourier_features: bool = True,
                 learned_sinusoidal_dim: int = 16, dtype: Optional[torch.dtype] = None,
                 learned_sinusoidal_cond: bool = False):
        super().__init__(
            dim=latent_in_features,
            block_channels=block_channels,
            channels=1,
            input_conditioning_dims=pc_latent_size,
            resnet_block_groups=resnet_block_groups,
            dropout=dropout,
            learned_sinusoidal_cond=learned_sinusoidal_cond,
            random_fourier_features=random_fourier_features,
            learned_sinusoidal_dim=learned_sinusoidal_dim,
        )
        self.latent_in_features = latent_in_features
        self.pc_latent_size = pc_latent_size
        self.resnet_block_groups = resnet_block_groups
        self.learned_sinusoidal_dim = learned_sinusoidal_dim
        self.dtype = dtype
