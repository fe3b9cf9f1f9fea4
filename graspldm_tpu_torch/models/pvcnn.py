"""Point-Voxel CNN encoder (torch, NCDHW voxel grids).

Counterpart of :mod:`graspldm_tpu.models.pvcnn`. Point features are
channel-first ``[B, C, N]`` and voxel grids ``[B, C, r, r, r]``, as in the
reference PVCNN; module names follow its key space
(``pvcnn_modules.point_features.{i}.voxel_layers.{j}``,
``point_features.layers.{j}``, ``conv_downscale``, ``out_layer``), which
:func:`graspldm_tpu.utils.torch_convert.pvcnn_encoder_params_from_torch`
reads. All of it is plain PyTorch: the JAX package runs it as plain XLA.
``PVConv(use_attention=True)`` runs full softmax attention over the r^3
voxels in place of its second SiLU (``voxel_layers.6``), and
``PVCNNEncoder(use_global_attention=True)`` a single-head attention block
over the points after ``conv_downscale`` (``global_attention``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import avg_voxelize, normalize_coords_for_voxelization, trilinear_devoxelize
from .layers import Attention1D

__all__ = ["SharedMLP", "SE", "VoxelAttention", "PVConv", "PVCNN", "GlobalAttention",
           "PVCNNEncoder", "pvcnn_block_spec"]


class SharedMLP(nn.Module):
    """Per-point (Conv1d 1x1 -> BatchNorm -> ReLU) x len(features)."""

    def __init__(self, in_channels: int, features: Sequence[int]):
        super().__init__()
        layers = []
        for f in features:
            layers += [nn.Conv1d(in_channels, f, 1), nn.BatchNorm1d(f, eps=1e-5), nn.ReLU()]
            in_channels = f
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        return self.layers(x)


class SE(nn.Module):
    """Squeeze-and-excitation over ``[B, C, r, r, r]`` (reduction 8; Swish
    gate, or ReLU with ``use_relu`` as PVCNN2 sets)."""

    def __init__(self, channels: int, use_relu: bool = False):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(channels, channels // 8, bias=False),
            nn.ReLU() if use_relu else nn.SiLU(),
            nn.Linear(channels // 8, channels, bias=False),
            nn.Sigmoid(),
        )

    def forward(self, x):
        s = self.fc(x.mean(dim=(2, 3, 4)))
        return x * s[:, :, None, None, None]


class VoxelAttention(Attention1D):
    """:class:`.layers.Attention1D` over the r^3 voxels of ``[B, C, r, r, r]``."""

    def forward(self, x, dtype: Optional[torch.dtype] = None):
        return super().forward(x.flatten(2), dtype).reshape(x.shape)


class PVConv(nn.Module):
    """Voxel Conv3d branch + per-point MLP branch, summed.

    Voxel coords are radius-normalized only with ``normalize`` (the JAX
    module's default is not to; PVCNN2 sets it, with ``with_se_relu``); the
    Dropout(0.1) keeps the reference's layer numbering (``voxel_layers.3``).
    ``use_attention`` puts :class:`VoxelAttention` in place of the second
    SiLU (``voxel_layers.6``), as the JAX module does."""

    def __init__(self, in_channels: int, out_channels: int, resolution: int,
                 normalize: bool = False, with_se_relu: bool = False,
                 use_attention: bool = False):
        super().__init__()
        self.resolution, self.normalize = resolution, normalize
        self.voxel_layers = nn.Sequential(
            nn.Conv3d(in_channels, out_channels, 3, padding=1),
            nn.GroupNorm(8, out_channels, eps=1e-5),
            nn.SiLU(),
            nn.Dropout(0.1),
            nn.Conv3d(out_channels, out_channels, 3, padding=1),
            nn.GroupNorm(8, out_channels, eps=1e-5),
            VoxelAttention(out_channels) if use_attention else nn.SiLU(),
            SE(out_channels, use_relu=with_se_relu),
        )
        self.point_features = SharedMLP(in_channels, [out_channels])

    def forward(self, features: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        """``features [B, C, N]``, ``coords [B, 3, N]`` -> ``[B, C_out, N]``."""
        r = self.resolution
        B = features.shape[0]
        vox = normalize_coords_for_voxelization(coords.transpose(1, 2), r,
                                                normalize=self.normalize)
        grid = avg_voxelize(features.transpose(1, 2), vox, r)  # [B, V, C]
        grid = grid.transpose(1, 2).reshape(B, -1, r, r, r)
        grid = self.voxel_layers(grid)
        grid = grid.reshape(B, grid.shape[1], r * r * r).transpose(1, 2)
        voxel_features = trilinear_devoxelize(grid, vox, r).transpose(1, 2)
        return voxel_features + self.point_features(features)


def pvcnn_block_spec(scale_channels: float, scale_voxel_resolution: float,
                     num_blocks: Sequence[int]) -> Tuple[Tuple[int, int, Optional[int]], ...]:
    """Base channels (64, 128, 1024, 2048) and resolutions (32, 16, -, -),
    scaled."""
    c = [int(b * scale_channels) for b in (64, 128, 1024, 2048)]
    r = [int(32 * scale_voxel_resolution), int(16 * scale_voxel_resolution)]
    if any(ci % 2 for ci in c) or any(ri % 2 for ri in r):
        raise ValueError(f"PVCNN scales give odd channels/resolutions: {c}, {r}")
    return tuple(zip(c, num_blocks, r + [None, None]))


class PVCNN(nn.Module):
    """PVConv stages (with a voxel resolution) then SharedMLP stages."""

    def __init__(self, in_channels: int = 3, scale_channels: float = 0.25,
                 scale_voxel_resolution: float = 0.75,
                 num_blocks: Sequence[int] = (1, 2, 1, 1)):
        super().__init__()
        self.block_spec = pvcnn_block_spec(scale_channels, scale_voxel_resolution, num_blocks)
        mods = []
        for out_ch, n_blocks, resolution in self.block_spec:
            for _ in range(n_blocks):
                if resolution is None:
                    mods.append(SharedMLP(in_channels, [out_ch]))
                else:
                    mods.append(PVConv(in_channels, out_ch, resolution))
                in_channels = out_ch
        self.point_features = nn.ModuleList(mods)
        self.out_channels = in_channels

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        """``[B, 3, N]`` (xyz first) -> ``[B, C_out, N]``."""
        coords = features[:, :3]
        for m in self.point_features:
            features = m(features, coords) if isinstance(m, PVConv) else m(features)
        return features


class GlobalAttention(nn.Module):
    """Single-head full attention over the points of ``[B, C, N]`` (no
    scaling), a residual add, then GroupNorm(8) and SiLU. Counterpart of
    the JAX package's ``pvcnn._GlobalAttention``."""

    def __init__(self, channels: int, num_groups: int = 8):
        super().__init__()
        self.q, self.k, self.v, self.out = (nn.Conv1d(channels, channels, 1) for _ in range(4))
        self.norm = nn.GroupNorm(num_groups, channels, eps=1e-5)

    def forward(self, x):
        w = torch.einsum("bci,bcj->bij", self.q(x), self.k(x)).softmax(dim=-1)
        h = self.out(torch.einsum("bij,bcj->bci", w, self.v(x)))
        return F.silu(self.norm(x + h))


class PVCNNEncoder(nn.Module):
    """Point cloud ``[B, N, 3]`` -> ``z_pc [B, out_channels, out_features]``
    (squeezed to ``[B, out_features]`` when ``out_channels == 1``);
    ``use_global_attention`` adds :class:`GlobalAttention` after
    ``conv_downscale``."""

    def __init__(self, out_features: int = 32, n_points: int = 1024,
                 scale_channels: float = 0.25, scale_voxel_resolution: float = 0.75,
                 num_blocks: Sequence[int] = (1, 1, 1, 1),
                 use_global_attention: bool = False, out_channels: int = 1):
        super().__init__()
        self.pvcnn_modules = PVCNN(3, scale_channels, scale_voxel_resolution, num_blocks)
        half = self.pvcnn_modules.out_channels // 2
        self.conv_downscale = nn.Conv1d(self.pvcnn_modules.out_channels, half, 1)
        self.global_attention = GlobalAttention(half) if use_global_attention else None
        self.out_layer = nn.Sequential(
            nn.Conv1d(half, out_channels, 1), nn.Linear(n_points, out_features)
        )
        self.out_channels = out_channels

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        out = self.pvcnn_modules(xyz.transpose(1, 2))
        out = self.conv_downscale(out)
        if self.global_attention is not None:
            out = self.global_attention(out)
        out = self.out_layer(out)  # [B, C_out, F]
        return out.squeeze(1) if self.out_channels == 1 else out
