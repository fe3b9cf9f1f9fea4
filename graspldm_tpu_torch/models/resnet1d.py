"""Conditional 1-D ResNet cores (non-temporal and time-conditioned), torch.

Counterpart of :mod:`graspldm_tpu.models.resnet1d`, in the reference's
channel-first layout: ``x [B, C=channels, L=dim]``. Parameters sit at the
module's top level (``init_conv``, ``blocks.{i}.{0..3}``,
``final_res_block``, ``final_conv``, ``input_emb_layers``, ``time_mlp``),
the key space :func:`graspldm_tpu.utils.torch_convert.
resnet1d_params_from_torch` reads.

The conditioning path carries two SiLUs: ``silu(Dense(z))`` here, then the
ResnetBlock's own ``mlp(silu(emb))``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .layers import (
    LinearAttention1D,
    PreNorm,
    RandomOrLearnedSinusoidalPosEmb,
    ResnetBlock1D,
    Residual,
    SinusoidalPosEmb,
)

__all__ = ["ResNet1D", "TimeConditionedResNet1D"]


class _ResNet1DBase(nn.Module):
    """Shared core: init conv, conditioned blocks, final head."""

    def _build_core(self, dim, block_channels, channels, out_channels, groups,
                    dropout, emb_dim):
        self.dim = dim
        self.block_channels = tuple(block_channels)
        self.init_conv = nn.Conv1d(channels, dim, 7, padding=3)
        self.blocks = nn.ModuleList()
        in_ch = dim
        for ch in self.block_channels:
            self.blocks.append(nn.ModuleList([
                ResnetBlock1D(in_ch, in_ch, emb_dim, groups),
                ResnetBlock1D(in_ch, in_ch, emb_dim, groups),
                Residual(PreNorm(in_ch, LinearAttention1D(in_ch))),
                nn.Conv1d(in_ch, ch, 3, padding=1),
            ]))
            in_ch = ch
        self.drop = nn.Dropout(dropout) if dropout is not None else nn.Identity()
        self.final_res_block = ResnetBlock1D(in_ch, in_ch, emb_dim, groups)
        self.final_conv = nn.Conv1d(in_ch, out_channels, 1)

    def _core(self, x, latent_emb):
        x = self.init_conv(x)
        for res1, res2, attn, proj in self.blocks:
            x = res2(res1(x, latent_emb), latent_emb)
            x = self.drop(proj(attn(x)))
        return self.final_conv(self.final_res_block(x, latent_emb))


class ResNet1D(_ResNet1DBase):
    """Input-conditioned (non-temporal) 1-D ResNet.

    ``x [B, channels, dim]``, ``z_cond [B, cond]`` or ``[B, Ce, cond]`` ->
    ``[B, out_channels, dim]``.
    """

    def __init__(self, dim: int, block_channels: Sequence[int] = (16, 64, 128, 64, 16),
                 channels: int = 1, out_channels: Optional[int] = None,
                 input_conditioning_dims: Optional[int] = None,
                 resnet_block_groups: int = 8, dropout: Optional[float] = None):
        super().__init__()
        emb_dim = dim * 4
        self.input_emb_layers = (
            nn.Sequential(nn.Linear(input_conditioning_dims, emb_dim), nn.SiLU())
            if input_conditioning_dims is not None else None
        )
        self._build_core(
            dim, block_channels, channels, out_channels or channels,
            resnet_block_groups, dropout,
            emb_dim if input_conditioning_dims is not None else None,
        )

    def forward(self, x, z_cond: Optional[torch.Tensor] = None):
        latent_emb = None
        if self.input_emb_layers is not None:
            if z_cond is None:
                raise ValueError("model is input-conditioned; z_cond required")
            latent_emb = self.input_emb_layers(z_cond)
        return self._core(x, latent_emb)


class TimeConditionedResNet1D(_ResNet1DBase):
    """Denoiser core: time + input conditioning.

    The time embedding (random Fourier features by default) is summed with
    the conditioning embedding, broadcast over conditioning channels when
    ``z_cond`` is ``[B, Ce, D]``.
    """

    def __init__(self, dim: int, block_channels: Sequence[int] = (16, 64, 128, 64, 16),
                 channels: int = 1, out_channels: Optional[int] = None,
                 input_conditioning_dims: Optional[int] = None,
                 resnet_block_groups: int = 8, dropout: Optional[float] = None,
                 learned_sinusoidal_cond: bool = False,
                 random_fourier_features: bool = False,
                 learned_sinusoidal_dim: int = 16):
        super().__init__()
        emb_dim = dim * 4
        if learned_sinusoidal_cond or random_fourier_features:
            pos = RandomOrLearnedSinusoidalPosEmb(
                learned_sinusoidal_dim, is_random=random_fourier_features
            )
            fourier_dim = learned_sinusoidal_dim + 1
        else:
            pos, fourier_dim = SinusoidalPosEmb(dim), dim
        self.random_fourier_features = random_fourier_features
        # nn.GELU() is the exact erf form, as flax's gelu(approximate=False)
        self.time_mlp = nn.Sequential(
            pos, nn.Linear(fourier_dim, emb_dim), nn.GELU(), nn.Linear(emb_dim, emb_dim)
        )
        self.input_emb_layers = (
            nn.Sequential(nn.Linear(input_conditioning_dims, emb_dim), nn.SiLU())
            if input_conditioning_dims is not None else None
        )
        self._build_core(
            dim, block_channels, channels, out_channels or channels,
            resnet_block_groups, dropout, emb_dim,
        )

    def forward(self, x, time, z_cond: Optional[torch.Tensor] = None):
        latent_emb = self.time_mlp(time)
        if self.input_emb_layers is not None:
            if z_cond is None:
                raise ValueError("model is input-conditioned; z_cond required")
            input_emb = self.input_emb_layers(z_cond)
            if input_emb.ndim == 3:
                latent_emb = latent_emb[:, None, :]
            latent_emb = latent_emb + input_emb
        return self._core(x, latent_emb)
