"""Flagship model factory: the fpc_1a_latentc3_z4_pc64 GraspLDM configuration.

Counterpart of :mod:`graspldm_tpu.flagship`: pc 1024 points -> z_pc [3, 64];
grasp latent 4; linear betas 5e-5..1e-3, T=1000, fixed_large, epsilon
prediction. The options this slice of the port does not carry (EDM
diffusion, class/region conditioning, a separate training dtype) raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from .diffusion import DiffusionSchedule, GaussianDiffusion1D
from .models import GraspCVAE, GraspLatentDDM

__all__ = ["FlagshipConfig", "build_flagship", "resolve_dtype", "init_params_"]


@dataclasses.dataclass(frozen=True)
class FlagshipConfig:
    pc_num_points: int = 1024
    pc_latent_size: int = 64
    pc_latent_channels: int = 3
    grasp_latent_size: int = 4
    grasp_representation_dims: int = 7  # tmrp(6) + success(1)
    num_output_qualities: Optional[int] = None
    block_channels: Tuple[int, ...] = (32, 64, 128, 256)
    resnet_block_groups: int = 4
    dropout: Optional[float] = 0.1
    pc_scale_channels: float = 0.75
    pc_scale_voxel_resolution: float = 0.75
    diffusion_timesteps: int = 1000
    beta_start: float = 5e-5
    beta_end: float = 1e-3
    beta_schedule: str = "linear"
    variance_type: str = "fixed_large"
    # compute dtype of the denoiser and decoder kernels (None = float32)
    denoiser_dtype: object = None
    elucidated: bool = False
    conditioning: Optional[str] = None


def resolve_dtype(d) -> Optional[torch.dtype]:
    """None | torch dtype | "bfloat16"/"float32" string -> torch dtype or None."""
    if d is None or isinstance(d, torch.dtype):
        return None if d == torch.float32 else d
    if d in ("float32", "fp32"):
        return None
    if d in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(f"unsupported compute dtype {d!r}")


@torch.no_grad()
def init_params_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every parameter and buffer of ``module`` from ``generator``.

    Dense/conv weights and biases ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (the
    scale of PyTorch's default init), norm gains 1 and shifts 0, random
    Fourier weights ~ N(0, 1); BatchNorm running stats are reset.
    """
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv3d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, (nn.GroupNorm, nn.BatchNorm1d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm1d):
                m.reset_running_stats()
        elif hasattr(m, "g") and isinstance(m.g, nn.Parameter):
            m.g.fill_(1.0)
        elif isinstance(getattr(m, "weights", None), torch.Tensor):
            m.weights.normal_(generator=generator)
    return module


def build_flagship(cfg: FlagshipConfig = FlagshipConfig(),
                   generator: Optional[torch.Generator] = None):
    """Returns ``(vae, ddm, diffusion)`` in eval mode on the CPU; with a
    ``generator`` their weights are drawn from it (:func:`init_params_`)."""
    if cfg.elucidated:
        raise NotImplementedError("EDM (elucidated) diffusion is not ported yet")
    if cfg.conditioning is not None:
        raise NotImplementedError("class/region conditioning is not ported yet")
    dtype = resolve_dtype(cfg.denoiser_dtype)
    vae = GraspCVAE(
        grasp_latent_size=cfg.grasp_latent_size,
        pc_latent_size=cfg.pc_latent_size,
        pc_latent_channels=cfg.pc_latent_channels,
        grasp_representation_dims=cfg.grasp_representation_dims,
        block_channels=cfg.block_channels,
        resnet_block_groups=cfg.resnet_block_groups,
        dropout=cfg.dropout,
        num_output_qualities=cfg.num_output_qualities,
        pc_num_points=cfg.pc_num_points,
        pc_scale_channels=cfg.pc_scale_channels,
        pc_scale_voxel_resolution=cfg.pc_scale_voxel_resolution,
        decoder_dtype=dtype,
    )
    ddm = GraspLatentDDM(
        latent_in_features=cfg.grasp_latent_size,
        pc_latent_size=cfg.pc_latent_size,
        block_channels=cfg.block_channels,
        resnet_block_groups=cfg.resnet_block_groups,
        dropout=cfg.dropout,
        dtype=dtype,
    )
    if generator is not None:
        init_params_(vae, generator)
        init_params_(ddm, generator)
    schedule = DiffusionSchedule.create(
        num_steps=cfg.diffusion_timesteps,
        beta_schedule=cfg.beta_schedule,
        beta_start=cfg.beta_start,
        beta_end=cfg.beta_end,
    )
    diffusion = GaussianDiffusion1D(
        schedule=schedule, n_dims=cfg.grasp_latent_size, variance_type=cfg.variance_type,
    )
    return vae.eval(), ddm.eval(), diffusion
