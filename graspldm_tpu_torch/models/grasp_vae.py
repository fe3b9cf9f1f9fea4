"""Point-cloud-conditioned grasp VAE (torch).

Counterpart of :class:`graspldm_tpu.models.grasp_vae.GraspCVAE`. Module
names follow the reference key space (``encoder.pc_encoder``,
``encoder.grasp_encoder.{in_layer,net,out_layer}``, ``bottleneck.{mu,logvar}``,
``decoder.{in_layer,net,tmrp,class_logits,qualities}``) that
:func:`graspldm_tpu.utils.torch_convert.grasp_cvae_variables_from_torch`
reads.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from .pvcnn import PVCNNEncoder
from .resnet1d import ResNet1D

__all__ = ["GraspCVAE", "VAEBottleneck"]


class VAEBottleneck(nn.Module):
    def __init__(self, in_features: int, latent_size: int):
        super().__init__()
        self.mu = nn.Linear(in_features, latent_size)
        self.logvar = nn.Linear(in_features, latent_size)

    def forward(self, z):
        return self.mu(z), self.logvar(z)


class _ConditionalCore(nn.Module):
    """Linear in-layer -> 1-channel sequence of length R -> ResNet1D."""

    def __init__(self, in_features, feature_resolution, block_channels, cond_dims,
                 groups, dropout, out_features: Optional[int],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_layer = nn.Linear(in_features, feature_resolution)
        self.net = ResNet1D(
            dim=feature_resolution, block_channels=block_channels, channels=1,
            input_conditioning_dims=cond_dims, resnet_block_groups=groups,
            dropout=dropout, dtype=dtype,
        )
        self.out_layer = (
            nn.Linear(feature_resolution, out_features) if out_features else None
        )

    def core(self, x, cond):
        h = self.net(self.in_layer(x)[:, None, :], z_cond=cond)[:, 0, :]  # [B, R]
        return self.out_layer(h) if self.out_layer is not None else h


class _Encoder(nn.Module):
    def __init__(self, pc_encoder, grasp_encoder):
        super().__init__()
        self.pc_encoder = pc_encoder
        self.grasp_encoder = grasp_encoder


class _Decoder(_ConditionalCore):
    def __init__(self, num_output_qualities: Optional[int], dtype: Optional[torch.dtype], **kw):
        super().__init__(out_features=None, dtype=dtype, **kw)
        R = kw["feature_resolution"]
        self.tmrp = nn.Linear(R, 6)
        self.class_logits = nn.Linear(R, 1)
        self.qualities = (
            nn.Linear(R, num_output_qualities) if num_output_qualities else None
        )


class GraspCVAE(nn.Module):
    """Point-cloud-conditioned grasp VAE; arguments mirror the JAX module.

    ``decoder_dtype`` is the declared compute dtype of the decoder
    (``None`` = float32): of its kernels on the generation path and of the
    plain ``decode``, whose core rounds where the JAX package's flax decoder
    in that dtype does (its in-layer and heads stay float32, as there).
    """

    def __init__(self, grasp_latent_size: int = 4, pc_latent_size: int = 64,
                 pc_latent_channels: int = 3, grasp_representation_dims: int = 7,
                 block_channels: Sequence[int] = (32, 64, 128, 256),
                 resnet_block_groups: int = 4, dropout: Optional[float] = 0.1,
                 intermediate_feature_resolution: int = 16,
                 num_output_qualities: Optional[int] = None,
                 pc_num_points: int = 1024, pc_scale_channels: float = 0.75,
                 pc_scale_voxel_resolution: float = 0.75,
                 pc_num_blocks: Sequence[int] = (1, 1, 1, 1),
                 decoder_dtype: Optional[torch.dtype] = None,
                 pc_use_global_attention: bool = False):
        super().__init__()
        self.grasp_latent_size = grasp_latent_size
        self.pc_latent_size = pc_latent_size
        self.pc_latent_channels = pc_latent_channels
        self.block_channels = tuple(block_channels)
        self.resnet_block_groups = resnet_block_groups
        self.intermediate_feature_resolution = intermediate_feature_resolution
        self.decoder_dtype = decoder_dtype
        R = intermediate_feature_resolution
        core = dict(
            feature_resolution=R, block_channels=block_channels,
            cond_dims=pc_latent_size, groups=resnet_block_groups, dropout=dropout,
        )
        self.encoder = _Encoder(
            PVCNNEncoder(
                out_features=pc_latent_size, n_points=pc_num_points,
                scale_channels=pc_scale_channels,
                scale_voxel_resolution=pc_scale_voxel_resolution,
                num_blocks=pc_num_blocks, out_channels=pc_latent_channels,
                use_global_attention=pc_use_global_attention,
            ),
            _ConditionalCore(grasp_representation_dims, out_features=grasp_latent_size,
                             **core),
        )
        self.bottleneck = VAEBottleneck(grasp_latent_size, grasp_latent_size)
        self.decoder = _Decoder(num_output_qualities, decoder_dtype,
                                in_features=grasp_latent_size, **core)

    def encode_pc(self, xyz: torch.Tensor) -> torch.Tensor:
        """``[B, N, 3]`` -> ``z_pc [B, C_pc, D_pc]``."""
        return self.encoder.pc_encoder(xyz)

    def encode_grasp(self, grasp: torch.Tensor, z_pc: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``grasp [BG, D_g]``, ``z_pc [BG, C_pc, D_pc]`` -> (mu, logvar)."""
        return self.bottleneck(self.encoder.grasp_encoder.core(grasp, z_pc))

    def decode(self, z_h: torch.Tensor, z_pc: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """``z_h [BG, L]``, ``z_pc [BG, C_pc, D_pc]`` ->
        (tmrp ``[BG, 6]``, cls_logits ``[BG, 1]``[, qualities]), float32;
        the core computes in ``decoder_dtype``."""
        h = self.decoder.core(z_h, z_pc).float()
        out = (self.decoder.tmrp(h), self.decoder.class_logits(h))
        if self.decoder.qualities is not None:
            out = out + (self.decoder.qualities(h),)
        return out
