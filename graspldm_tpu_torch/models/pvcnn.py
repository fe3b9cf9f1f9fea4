"""Point-Voxel CNN encoder (torch, NCDHW voxel grids).

Counterpart of :mod:`graspldm_tpu.models.pvcnn`. Point features are
channel-first ``[B, C, N]`` and voxel grids ``[B, C, r, r, r]``, as in the
reference PVCNN; module names follow its key space
(``pvcnn_modules.point_features.{i}.voxel_layers.{j}``,
``point_features.layers.{j}``, ``conv_downscale``, ``out_layer``), which
:func:`graspldm_tpu.utils.torch_convert.pvcnn_encoder_params_from_torch`
reads. All of it is plain PyTorch: the JAX package runs it as plain XLA.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops import avg_voxelize, normalize_coords_for_voxelization, trilinear_devoxelize

__all__ = ["SharedMLP", "SE", "PVConv", "PVCNN", "PVCNNEncoder", "pvcnn_block_spec"]


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
    """Squeeze-and-excitation over ``[B, C, r, r, r]`` (reduction 8, Swish)."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(channels, channels // 8, bias=False),
            nn.SiLU(),
            nn.Linear(channels // 8, channels, bias=False),
            nn.Sigmoid(),
        )

    def forward(self, x):
        s = self.fc(x.mean(dim=(2, 3, 4)))
        return x * s[:, :, None, None, None]


class PVConv(nn.Module):
    """Voxel Conv3d branch + per-point MLP branch, summed.

    Voxel coords are not radius-normalized (the JAX module's default); the
    Dropout(0.1) keeps the reference's layer numbering (``voxel_layers.3``)."""

    def __init__(self, in_channels: int, out_channels: int, resolution: int):
        super().__init__()
        self.resolution = resolution
        self.voxel_layers = nn.Sequential(
            nn.Conv3d(in_channels, out_channels, 3, padding=1),
            nn.GroupNorm(8, out_channels, eps=1e-5),
            nn.SiLU(),
            nn.Dropout(0.1),
            nn.Conv3d(out_channels, out_channels, 3, padding=1),
            nn.GroupNorm(8, out_channels, eps=1e-5),
            nn.SiLU(),
            SE(out_channels),
        )
        self.point_features = SharedMLP(in_channels, [out_channels])

    def forward(self, features: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        """``features [B, C, N]``, ``coords [B, 3, N]`` -> ``[B, C_out, N]``."""
        r = self.resolution
        B = features.shape[0]
        vox = normalize_coords_for_voxelization(coords.transpose(1, 2), r, normalize=False)
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


class PVCNNEncoder(nn.Module):
    """Point cloud ``[B, N, 3]`` -> ``z_pc [B, out_channels, out_features]``
    (squeezed to ``[B, out_features]`` when ``out_channels == 1``)."""

    def __init__(self, out_features: int = 32, n_points: int = 1024,
                 scale_channels: float = 0.25, scale_voxel_resolution: float = 0.75,
                 num_blocks: Sequence[int] = (1, 1, 1, 1),
                 use_global_attention: bool = False, out_channels: int = 1):
        super().__init__()
        if use_global_attention:
            raise NotImplementedError("PVCNNEncoder global attention is not ported yet")
        self.pvcnn_modules = PVCNN(3, scale_channels, scale_voxel_resolution, num_blocks)
        half = self.pvcnn_modules.out_channels // 2
        self.conv_downscale = nn.Conv1d(self.pvcnn_modules.out_channels, half, 1)
        self.out_layer = nn.Sequential(
            nn.Conv1d(half, out_channels, 1), nn.Linear(n_points, out_features)
        )
        self.out_channels = out_channels

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        out = self.pvcnn_modules(xyz.transpose(1, 2))
        out = self.out_layer(self.conv_downscale(out))  # [B, C_out, F]
        return out.squeeze(1) if self.out_channels == 1 else out
