"""Plain float32 PyTorch reference of the GraspLDM generation path.

The modules follow the published GraspLDM code (github.com/kuldeepbrd1/
graspLDM, arXiv 2312.11243) in its state-dict key space, so one state dict
loads into the reference and into the program under test alike. Nothing
here imports the program: this is a frozen, float32-only copy of the
plain equations (no compute-dtype casts, no kernels, no packing).

* ``PVCNNEncoder``: point cloud ``[B, N, 3]`` -> ``z_pc [B, Ce, D_pc]``
  (voxel branch: average voxelization as a one-hot product, Conv3d,
  GroupNorm, SiLU, squeeze-and-excitation, trilinear devoxelization; point
  branch: 1x1 conv, BatchNorm, ReLU).
* ``ResNet1D`` / ``TimeConditionedResNet1D``: the conditional 1-D ResNet of
  the decoder and of the denoiser (weight-standardised k3 convs, GroupNorm,
  FiLM over the conditioning channels, linear attention).
* ``GraspCVAE`` (the decoder is what generation uses) and
  ``GraspLatentDDM`` (the epsilon-prediction denoiser).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# point cloud encoder
# ---------------------------------------------------------------------------


def voxel_coords(coords: torch.Tensor, r: int) -> torch.Tensor:
    """Raw ``[B, N, 3]`` coordinates -> continuous voxel coordinates in
    ``[0, r - 1]`` (centred on the cloud mean, not radius-normalised)."""
    centered = coords - coords.mean(dim=1, keepdim=True)
    return ((centered + 1.0) / 2.0 * r).clamp(0.0, r - 1.0)


def avg_voxelize(features: torch.Tensor, vox: torch.Tensor, r: int) -> torch.Tensor:
    """Mean of ``[B, N, C]`` point features per voxel -> ``[B, r^3, C]``;
    coordinates round half to even, empty voxels are 0."""
    B, N, _ = features.shape
    idx = torch.round(vox).long()
    flat = idx[..., 0] * (r * r) + idx[..., 1] * r + idx[..., 2]
    onehot = torch.zeros(B, r ** 3, N, dtype=torch.float32, device=features.device)
    onehot.scatter_(1, flat[:, None, :], 1.0)
    counts = onehot.sum(dim=2).clamp(min=1.0)
    return torch.bmm(onehot, features) / counts[..., None]


def trilinear_devoxelize(grid: torch.Tensor, vox: torch.Tensor, r: int) -> torch.Tensor:
    """Trilinear interpolation of ``[B, r^3, C]`` at ``[B, N, 3]`` voxel
    coordinates; the upper corner is clamped to ``r - 1``."""
    lo = torch.floor(vox)
    frac = vox - lo
    lo_i = lo.long()
    hi_i = (lo_i + 1).clamp(max=r - 1)
    C = grid.shape[-1]
    out = None
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                ix = (hi_i if cx else lo_i)[..., 0]
                iy = (hi_i if cy else lo_i)[..., 1]
                iz = (hi_i if cz else lo_i)[..., 2]
                w = ((frac[..., 0] if cx else 1.0 - frac[..., 0])
                     * (frac[..., 1] if cy else 1.0 - frac[..., 1])
                     * (frac[..., 2] if cz else 1.0 - frac[..., 2]))
                flat = ix * (r * r) + iy * r + iz
                term = torch.gather(grid, 1, flat[..., None].expand(-1, -1, C)) * w[..., None]
                out = term if out is None else out + term
    return out


class SharedMLP(nn.Module):
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
    def __init__(self, channels: int):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(channels, channels // 8, bias=False), nn.SiLU(),
            nn.Linear(channels // 8, channels, bias=False), nn.Sigmoid(),
        )

    def forward(self, x):
        return x * self.fc(x.mean(dim=(2, 3, 4)))[:, :, None, None, None]


class PVConv(nn.Module):
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

    def forward(self, features, coords):
        r, B = self.resolution, features.shape[0]
        vox = voxel_coords(coords.transpose(1, 2), r)
        grid = avg_voxelize(features.transpose(1, 2), vox, r)
        grid = self.voxel_layers(grid.transpose(1, 2).reshape(B, -1, r, r, r))
        grid = grid.reshape(B, grid.shape[1], r ** 3).transpose(1, 2)
        return trilinear_devoxelize(grid, vox, r).transpose(1, 2) + self.point_features(features)


class PVCNN(nn.Module):
    def __init__(self, scale_channels: float, scale_voxel_resolution: float,
                 num_blocks: Sequence[int]):
        super().__init__()
        chans = [int(b * scale_channels) for b in (64, 128, 1024, 2048)]
        res = [int(32 * scale_voxel_resolution), int(16 * scale_voxel_resolution), None, None]
        mods, cin = [], 3
        for cout, n, r in zip(chans, num_blocks, res):
            for _ in range(n):
                mods.append(SharedMLP(cin, [cout]) if r is None else PVConv(cin, cout, r))
                cin = cout
        self.point_features = nn.ModuleList(mods)
        self.out_channels = cin

    def forward(self, features):
        coords = features[:, :3]
        for m in self.point_features:
            features = m(features, coords) if isinstance(m, PVConv) else m(features)
        return features


class PVCNNEncoder(nn.Module):
    def __init__(self, out_features: int, n_points: int, scale_channels: float,
                 scale_voxel_resolution: float, num_blocks: Sequence[int], out_channels: int):
        super().__init__()
        self.pvcnn_modules = PVCNN(scale_channels, scale_voxel_resolution, num_blocks)
        half = self.pvcnn_modules.out_channels // 2
        self.conv_downscale = nn.Conv1d(self.pvcnn_modules.out_channels, half, 1)
        self.out_layer = nn.Sequential(nn.Conv1d(half, out_channels, 1),
                                       nn.Linear(n_points, out_features))

    def forward(self, xyz):
        out = self.conv_downscale(self.pvcnn_modules(xyz.transpose(1, 2)))
        return self.out_layer(out)


# ---------------------------------------------------------------------------
# conditional 1-D ResNet
# ---------------------------------------------------------------------------


class RandomFourierEmb(nn.Module):
    """``[t, sin(2 pi t w), cos(2 pi t w)]`` with frozen random ``w``."""

    def __init__(self, dim: int):
        super().__init__()
        self.register_buffer("weights", torch.zeros(dim // 2))

    def forward(self, t):
        t = t.float()[:, None]
        f = t * self.weights[None, :] * (2.0 * math.pi)
        return torch.cat([t, f.sin(), f.cos()], dim=-1)


class WSConv1d(nn.Conv1d):
    """k3 convolution with the weight standardised per output channel over
    (in, k), biased variance, eps 1e-5."""

    def forward(self, x):
        w = self.weight
        mean = w.mean(dim=(1, 2), keepdim=True)
        var = w.var(dim=(1, 2), keepdim=True, unbiased=False)
        return F.conv1d(x, (w - mean) * torch.rsqrt(var + 1e-5), self.bias, padding=1)


class ChannelLayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, dim, 1))

    def forward(self, x):
        var = x.var(dim=1, unbiased=False, keepdim=True)
        return (x - x.mean(dim=1, keepdim=True)) * torch.rsqrt(var + 1e-5) * self.g


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.fn = fn
        self.norm = ChannelLayerNorm(dim)

    def forward(self, x):
        return self.fn(self.norm(x))


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x) + x


class Block1D(nn.Module):
    def __init__(self, dim: int, dim_out: int, groups: int):
        super().__init__()
        self.proj = WSConv1d(dim, dim_out, 3, padding=1)
        self.norm = nn.GroupNorm(groups, dim_out, eps=1e-5)

    def forward(self, x, scale_shift=None):
        x = self.norm(self.proj(x))
        if scale_shift is not None:
            scale, shift = scale_shift  # [B, Ce, C]: summed over the conditioning channels
            x = x * (scale.sum(1)[:, :, None] + scale.shape[1]) + shift.sum(1)[:, :, None]
        return F.silu(x)


class ResnetBlock1D(nn.Module):
    def __init__(self, dim: int, emb_dim: int, groups: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.SiLU(), nn.Linear(emb_dim, dim * 2))
        self.block1 = Block1D(dim, dim, groups)
        self.block2 = Block1D(dim, dim, groups)
        self.res_conv = nn.Identity()

    def forward(self, x, emb):
        h = self.block1(x, self.mlp(emb).chunk(2, dim=-1))
        return self.block2(h) + x


class LinearAttention1D(nn.Module):
    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv1d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Sequential(nn.Conv1d(hidden, dim, 1), ChannelLayerNorm(dim))

    def forward(self, x):
        B, _, L = x.shape
        q, k, v = (t.reshape(B, self.heads, self.dim_head, L)
                   for t in self.to_qkv(x).chunk(3, dim=1))
        q = q.softmax(dim=-2) * (self.dim_head ** -0.5)
        k = k.softmax(dim=-1)
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhde,bhdn->bhen", context, q).reshape(B, -1, L)
        return self.to_out(out)


class _Core(nn.Module):
    def _build(self, dim, block_channels, emb_dim, groups):
        self.init_conv = nn.Conv1d(1, dim, 7, padding=3)
        self.blocks = nn.ModuleList()
        cin = dim
        for ch in block_channels:
            self.blocks.append(nn.ModuleList([
                ResnetBlock1D(cin, emb_dim, groups),
                ResnetBlock1D(cin, emb_dim, groups),
                Residual(PreNorm(cin, LinearAttention1D(cin))),
                nn.Conv1d(cin, ch, 3, padding=1),
            ]))
            cin = ch
        self.final_res_block = ResnetBlock1D(cin, emb_dim, groups)
        self.final_conv = nn.Conv1d(cin, 1, 1)

    def _core(self, x, emb):
        x = self.init_conv(x)
        for res1, res2, attn, proj in self.blocks:
            x = proj(attn(res2(res1(x, emb), emb)))
        return self.final_conv(self.final_res_block(x, emb))


class ResNet1D(_Core):
    """Input-conditioned core: ``x [B, 1, L]``, ``z [B, Ce, D]`` -> ``[B, 1, L]``."""

    def __init__(self, dim, block_channels, cond_dims, groups):
        super().__init__()
        self.input_emb_layers = nn.Sequential(nn.Linear(cond_dims, dim * 4), nn.SiLU())
        self._build(dim, block_channels, dim * 4, groups)

    def forward(self, x, z):
        return self._core(x, self.input_emb_layers(z))


class TimeConditionedResNet1D(_Core):
    """Denoiser core: random Fourier time features + MLP, plus the
    conditioning embedding, broadcast over the conditioning channels."""

    def __init__(self, dim, block_channels, cond_dims, groups, fourier_dim):
        super().__init__()
        E = dim * 4
        self.time_mlp = nn.Sequential(RandomFourierEmb(fourier_dim), nn.Linear(fourier_dim + 1, E),
                                      nn.GELU(), nn.Linear(E, E))
        self.input_emb_layers = nn.Sequential(nn.Linear(cond_dims, E), nn.SiLU())
        self._build(dim, block_channels, E, groups)

    def forward(self, x, t, z):
        return self._core(x, self.time_mlp(t)[:, None, :] + self.input_emb_layers(z))


class GraspLatentDDM(TimeConditionedResNet1D):
    def __init__(self, cfg: dict):
        super().__init__(cfg["grasp_latent_size"], cfg["block_channels"], cfg["pc_latent_size"],
                         cfg["resnet_block_groups"], cfg["learned_sinusoidal_dim"])


class _ConditionalCore(nn.Module):
    def __init__(self, in_features, R, block_channels, cond_dims, groups, out_features=None):
        super().__init__()
        self.in_layer = nn.Linear(in_features, R)
        self.net = ResNet1D(R, block_channels, cond_dims, groups)
        self.out_layer = nn.Linear(R, out_features) if out_features else None


class _Encoder(nn.Module):
    def __init__(self, pc_encoder, grasp_encoder):
        super().__init__()
        self.pc_encoder = pc_encoder
        self.grasp_encoder = grasp_encoder


class _Bottleneck(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.mu = nn.Linear(n, n)
        self.logvar = nn.Linear(n, n)


class _Decoder(_ConditionalCore):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.tmrp = nn.Linear(kw["R"], 6)
        self.class_logits = nn.Linear(kw["R"], 1)


class GraspCVAE(nn.Module):
    """The grasp VAE of the configuration (no output qualities)."""

    def __init__(self, cfg: dict):
        super().__init__()
        R = cfg["intermediate_feature_resolution"]
        core = dict(R=R, block_channels=cfg["block_channels"], cond_dims=cfg["pc_latent_size"],
                    groups=cfg["resnet_block_groups"])
        self.encoder = _Encoder(
            PVCNNEncoder(cfg["pc_latent_size"], cfg["pc_num_points"], cfg["pc_scale_channels"],
                         cfg["pc_scale_voxel_resolution"], cfg["pc_num_blocks"],
                         cfg["pc_latent_channels"]),
            _ConditionalCore(cfg["grasp_representation_dims"],
                             out_features=cfg["grasp_latent_size"], **core),
        )
        self.bottleneck = _Bottleneck(cfg["grasp_latent_size"])
        self.decoder = _Decoder(in_features=cfg["grasp_latent_size"], **core)

    def encode_pc(self, xyz: torch.Tensor) -> torch.Tensor:
        return self.encoder.pc_encoder(xyz)

    def decode(self, z_h: torch.Tensor, z_pc: torch.Tensor):
        """``z_h [R, L]``, ``z_pc [R, Ce, D]`` -> (tmrp ``[R, 6]``, logit ``[R, 1]``)."""
        dec = self.decoder
        h = dec.net(dec.in_layer(z_h)[:, None, :], z_pc)[:, 0, :]
        return dec.tmrp(h), dec.class_logits(h)


def build(cfg: dict, device=None, with_denoiser: bool = True):
    """The reference modules of a configuration, in eval mode, with
    uninitialised storage on ``device`` (fill them from a state dict)."""
    with torch.device("meta"):
        vae = GraspCVAE(cfg)
        ddm = GraspLatentDDM(cfg) if with_denoiser else None
    vae = vae.to_empty(device=device).eval()
    ddm = None if ddm is None else ddm.to_empty(device=device).eval()
    return vae, ddm
