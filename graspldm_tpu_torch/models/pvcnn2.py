"""PVCNN2: PointNet++ set abstraction / feature propagation with PVConv (torch).

Counterpart of :mod:`graspldm_tpu.models.pvcnn2` (the reference's
``pvcnn_base.py:180-279`` and ``modules/pointnet.py:11-135``), channel-first
as :mod:`.pvcnn`: point features ``[B, C, N]``, coords ``[B, 3, N]``. The
set-abstraction modules pick their centres with furthest point sampling
(``ops.furthest_point_sample``: ``fps_kernel`` on the card), group
ball-query neighbourhoods and max-pool a shared MLP over them; the
feature-propagation modules interpolate from the 3 nearest centres.

The JAX modules' ``include_coordinates`` (default True, set by no caller)
is always on: grouped and global features carry the coordinates. Module
names: ``sa_layers.{i}`` holds stage i's PVConvs, then its SA module;
``fp_layers.{i}`` its FP module, then its PVConvs; an SA module's MLPs are
``mlps.{j}``, an FP module's is ``mlp``. :mod:`..utils.convert` maps the JAX
package's variables onto them. Inference only: BatchNorm uses its running
statistics and dropout is off (``.eval()``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops import ball_query, furthest_point_sample, gather_points, group_points, three_nn_interpolate
from .pvcnn import PVConv, SharedMLP

__all__ = [
    "PointNetSAModule",
    "PointNetMSGSAModule",
    "PointNetAModule",
    "PointNetFPModule",
    "PVCNN2",
    "PVCNN2Encoder",
    "PointNet2",
    "PointNet2SSG",
    "PointNet2MSG",
    "SA_BLOCKS",
    "FP_BLOCKS",
]

# (pvconv cfg (out_ch, num_blocks, voxel_res) | None,
#  sa cfg (num_centers, radius, num_neighbors, mlp_channels))
SA_BLOCKS = (
    ((32, 1, 32), (1024, 0.1, 32, (32, 64))),
    ((64, 2, 16), (256, 0.2, 32, (64, 128))),
    ((128, 1, 8), (64, 0.4, 32, (128, 256))),
    (None, (16, 0.8, 32, (256, 256, 512))),
)
# ((fp mlp channels), pvconv cfg (out_ch, num_blocks, voxel_res))
FP_BLOCKS = (
    ((256, 256), (256, 1, 8)),
    ((256, 256), (256, 1, 8)),
    ((256, 128), (128, 2, 16)),
    ((128, 128, 64), (64, 1, 32)),
)


def _group(features, xyz, centers, radius, num_neighbors):
    """Ball-query neighbourhoods of ``centers [B, M, 3]`` in ``xyz [B, N, 3]``
    -> ``[B, 3+C, M, U]``: neighbour coords relative to their centre, then
    neighbour features."""
    idx = ball_query(centers, xyz, radius, num_neighbors)
    rel = group_points(xyz, idx) - centers[:, :, None, :]
    grouped = torch.cat([rel, group_points(features.transpose(1, 2), idx)], dim=-1)
    return grouped.permute(0, 3, 1, 2)


def _pooled(mlp: SharedMLP, grouped: torch.Tensor) -> torch.Tensor:
    """The per-point MLP over every neighbour of ``grouped [B, C, M, U]``
    (as ``[B, C, M*U]``), max-pooled over each group -> ``[B, C', M]``."""
    B, C, M, U = grouped.shape
    return mlp(grouped.reshape(B, C, M * U)).reshape(B, -1, M, U).amax(dim=-1)


def _centers(coords: torch.Tensor, num_centers: int) -> torch.Tensor:
    """FPS centres of ``coords [B, 3, N]`` -> ``[B, M, 3]``."""
    xyz = coords.transpose(1, 2)
    return gather_points(xyz, furthest_point_sample(xyz, num_centers))


class PointNetSAModule(nn.Module):
    """Set abstraction: FPS centres -> ball-query groups -> shared MLP ->
    max over each group. ``features [B, C, N]``, ``coords [B, 3, N]`` ->
    (``[B, C', M]``, centres ``[B, 3, M]``)."""

    def __init__(self, in_channels: int, num_centers: int, radius: float, num_neighbors: int,
                 mlp_channels: Sequence[int]):
        super().__init__()
        self.num_centers, self.radius, self.num_neighbors = num_centers, radius, num_neighbors
        self.mlps = nn.ModuleList([SharedMLP(in_channels + 3, mlp_channels)])
        self.out_channels = mlp_channels[-1]

    def forward(self, features, coords):
        centers = _centers(coords, self.num_centers)
        g = _group(features, coords.transpose(1, 2), centers, self.radius, self.num_neighbors)
        return _pooled(self.mlps[0], g), centers.transpose(1, 2)


class PointNetMSGSAModule(nn.Module):
    """Multi-scale-grouping set abstraction: one ball query and MLP per
    radius around the same FPS centres, the pooled features concatenated."""

    def __init__(self, in_channels: int, num_centers: int, radii: Sequence[float],
                 num_neighbors: Sequence[int], mlp_channels: Sequence[Sequence[int]]):
        super().__init__()
        self.num_centers, self.radii, self.num_neighbors = num_centers, radii, num_neighbors
        self.mlps = nn.ModuleList([SharedMLP(in_channels + 3, ch) for ch in mlp_channels])
        self.out_channels = sum(ch[-1] for ch in mlp_channels)

    def forward(self, features, coords):
        centers = _centers(coords, self.num_centers)
        xyz = coords.transpose(1, 2)
        outs = [_pooled(mlp, _group(features, xyz, centers, r, u))
                for mlp, r, u in zip(self.mlps, self.radii, self.num_neighbors)]
        return torch.cat(outs, dim=1), centers.transpose(1, 2)


class PointNetAModule(nn.Module):
    """Global set abstraction: shared MLP(s) over all points (features, then
    coords), max-pooled to one centre at the origin -> (``[B, C', 1]``,
    zeros ``[B, 3, 1]``). ``mlp_channels`` is one channel list or a list of
    them, whose pooled outputs are concatenated."""

    def __init__(self, in_channels: int, mlp_channels: Sequence):
        super().__init__()
        mlps = mlp_channels if isinstance(mlp_channels[0], (list, tuple)) else [mlp_channels]
        self.mlps = nn.ModuleList([SharedMLP(in_channels + 3, ch) for ch in mlps])
        self.out_channels = sum(ch[-1] for ch in mlps)

    def forward(self, features, coords):
        features = torch.cat([features, coords], dim=1)
        out = torch.cat([mlp(features).amax(dim=-1, keepdim=True) for mlp in self.mlps], dim=1)
        return out, coords.new_zeros(coords.shape[0], 3, 1)


class PointNetFPModule(nn.Module):
    """Feature propagation: 3-NN interpolation of the centres' features at
    the points, concatenated with the points' own (skip) features, then a
    shared MLP."""

    def __init__(self, in_channels: int, mlp_channels: Sequence[int]):
        super().__init__()
        self.mlp = SharedMLP(in_channels, mlp_channels)
        self.out_channels = mlp_channels[-1]

    def forward(self, points_coords, centers_coords, centers_features,
                points_features: Optional[torch.Tensor] = None):
        M = centers_coords.shape[2]
        if M < 3:
            # fewer than 3 centres (after a global PointNetAModule): repeated
            # centres make the 3-NN exact, as the JAX package does
            reps = 3 - M + 1
            centers_coords = torch.cat([centers_coords] * reps, dim=2)
            centers_features = torch.cat([centers_features] * reps, dim=2)
        interp = three_nn_interpolate(points_coords.transpose(1, 2), centers_coords.transpose(1, 2),
                                      centers_features.transpose(1, 2)).transpose(1, 2)
        if points_features is not None and points_features.shape[1] > 0:
            interp = torch.cat([interp, points_features], dim=1)
        return self.mlp(interp)


def _pvconvs(c_in: int, conv_cfg) -> Tuple[list, int]:
    if conv_cfg is None:
        return [], c_in
    out_ch, n_blocks, res = conv_cfg
    mods = []
    for _ in range(n_blocks):
        mods.append(PVConv(c_in, out_ch, res, normalize=True, with_se_relu=True))
        c_in = out_ch
    return mods, c_in


class PVCNN2(nn.Module):
    """The SA/FP hourglass with PVConv stages: ``[B, 3+extra, N]`` (xyz
    first) -> ``[B, C_out, N]``. Only the raw extra features skip into the
    last FP stage (``pvcnn_base.py:237``)."""

    def __init__(self, extra_feature_channels: int = 0, sa_blocks: Tuple = SA_BLOCKS,
                 fp_blocks: Tuple = FP_BLOCKS):
        super().__init__()
        c = 3 + extra_feature_channels
        skip = []
        self.sa_layers = nn.ModuleList()
        for conv_cfg, (num_centers, radius, num_neighbors, mlp_ch) in sa_blocks:
            skip.append(c)
            mods, c = _pvconvs(c, conv_cfg)
            sa = PointNetSAModule(c, num_centers, radius, num_neighbors, mlp_ch)
            self.sa_layers.append(nn.ModuleList(mods + [sa]))
            c = sa.out_channels
        skip[0] = extra_feature_channels
        self.fp_layers = nn.ModuleList()
        for fi, (fp_ch, conv_cfg) in enumerate(fp_blocks):
            fp = PointNetFPModule(c + skip[-1 - fi], fp_ch)
            mods, c = _pvconvs(fp.out_channels, conv_cfg)
            self.fp_layers.append(nn.ModuleList([fp] + mods))
        self.out_channels = c

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        coords, extras = features[:, :3], features[:, 3:]
        skip_feats, skip_coords = [], []
        for layers in self.sa_layers:
            skip_feats.append(features)
            skip_coords.append(coords)
            for conv in layers[:-1]:
                features = conv(features, coords)
            features, coords = layers[-1](features, coords)
        skip_feats[0] = extras
        for fi, layers in enumerate(self.fp_layers):
            points_coords = skip_coords[-1 - fi]
            features = layers[0](points_coords, coords, features, skip_feats[-1 - fi])
            coords = points_coords
            for conv in layers[1:]:
                features = conv(features, coords)
        return features


class PointNet2(nn.Module):
    """The pure PointNet++ hourglass (no PVConv): SA stages (single-scale,
    multi-scale when the radius is a list, global when ``num_centers`` is
    None), then FP stages with skips of each level's full features.
    ``[B, 3+extra, N]`` (xyz first) -> ``[B, C_out, N]``."""

    def __init__(self, sa_blocks: Tuple = (), fp_blocks: Tuple = (),
                 extra_feature_channels: int = 3):
        super().__init__()
        c = 3 + extra_feature_channels
        skip = []
        self.sa_layers = nn.ModuleList()
        for num_centers, radius, num_neighbors, mlp_ch in sa_blocks:
            skip.append(c)
            if num_centers is None:
                sa = PointNetAModule(c, mlp_ch)
            elif isinstance(radius, (list, tuple)):
                sa = PointNetMSGSAModule(c, num_centers, radius, num_neighbors, mlp_ch)
            else:
                sa = PointNetSAModule(c, num_centers, radius, num_neighbors, mlp_ch)
            self.sa_layers.append(sa)
            c = sa.out_channels
        self.fp_layers = nn.ModuleList()
        for fi, fp_ch in enumerate(fp_blocks):
            self.fp_layers.append(PointNetFPModule(c + skip[-1 - fi], fp_ch))
            c = fp_ch[-1]
        self.out_channels = c

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        coords = features[:, :3]
        skip_feats, skip_coords = [], []
        for sa in self.sa_layers:
            skip_feats.append(features)
            skip_coords.append(coords)
            features, coords = sa(features, coords)
        for fi, fp in enumerate(self.fp_layers):
            points_coords = skip_coords[-1 - fi]
            features = fp(points_coords, coords, features, skip_feats[-1 - fi])
            coords = points_coords
        return features


class PointNet2SSG(PointNet2):
    """Single-scale-grouping configuration (``pointnet2.py:98-123``)."""

    def __init__(self, extra_feature_channels: int = 3):
        super().__init__(
            sa_blocks=((512, 0.2, 64, (64, 64, 128)),
                       (128, 0.4, 64, (128, 128, 256)),
                       (None, None, None, (256, 512, 1024))),
            fp_blocks=((256, 256), (256, 128), (128, 128, 128)),
            extra_feature_channels=extra_feature_channels)


class PointNet2MSG(PointNet2):
    """Multi-scale-grouping configuration (``pointnet2.py:126-159``)."""

    def __init__(self, extra_feature_channels: int = 3):
        super().__init__(
            sa_blocks=((512, (0.1, 0.2, 0.4), (32, 64, 128),
                        ((32, 32, 64), (64, 64, 128), (64, 96, 128))),
                       (128, (0.4, 0.8), (64, 128), ((128, 128, 256), (128, 196, 256))),
                       (None, None, None, (256, 512, 1024))),
            fp_blocks=((256, 256), (256, 128), (128, 128, 128)),
            extra_feature_channels=extra_feature_channels)


class PVCNN2Encoder(nn.Module):
    """PVCNN2 backbone with the PVCNNEncoder head (reference
    ``pc_encoders.py:139-220``): ``xyz [B, N, 3+extra]`` -> ``[B, out_channels,
    out_features]``, squeezed to ``[B, out_features]`` when ``out_channels``
    is 1."""

    def __init__(self, out_features: int = 32, n_points: int = 1024,
                 extra_feature_channels: int = 0, out_channels: int = 1):
        super().__init__()
        self.pvcnn_modules = PVCNN2(extra_feature_channels)
        c = self.pvcnn_modules.out_channels
        self.conv_downscale = nn.Conv1d(c, c // 2, 1)
        self.out_layer = nn.Sequential(nn.Conv1d(c // 2, out_channels, 1),
                                       nn.Linear(n_points, out_features))
        self.out_channels = out_channels

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        out = self.pvcnn_modules(xyz.transpose(1, 2))
        out = self.out_layer(self.conv_downscale(out))
        return out.squeeze(1) if self.out_channels == 1 else out
