"""Shared 1-D network building blocks (torch, channel-first ``[B, C, L]``).

Counterpart of :mod:`graspldm_tpu.models.layers`. Module and parameter
names follow the reference PyTorch key space that
:mod:`graspldm_tpu.utils.torch_convert` reads, so a port ``state_dict``
converts straight into JAX variables and back (:mod:`..utils.convert`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "SinusoidalPosEmb",
    "RandomOrLearnedSinusoidalPosEmb",
    "WSConv1d",
    "ChannelLayerNorm",
    "Block1D",
    "ResnetBlock1D",
    "LinearAttention1D",
    "PreNorm",
    "Residual",
    "film_scale_shift",
    "standardize_conv_weight",
]


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        scale = math.log(10000.0) / (half - 1)
        freqs = torch.exp(torch.arange(half, device=t.device) * -scale)
        args = t.float()[:, None] * freqs[None, :]
        return torch.cat([args.sin(), args.cos()], dim=-1)


class RandomOrLearnedSinusoidalPosEmb(nn.Module):
    """Fourier features of the timestep; output width ``dim + 1``.

    Random features are a frozen buffer (the flax ``constants`` collection);
    learned ones a parameter. Either way the state-dict key is ``weights``.
    """

    def __init__(self, dim: int, is_random: bool = True):
        super().__init__()
        w = torch.randn(dim // 2)
        if is_random:
            self.register_buffer("weights", w)
        else:
            self.weights = nn.Parameter(w)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()[:, None]
        freqs = t * self.weights[None, :] * (2.0 * math.pi)
        return torch.cat([t, freqs.sin(), freqs.cos()], dim=-1)


def standardize_conv_weight(weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-output-channel standardization over (in, k) with the BIASED
    variance, in float32 (``torch.var`` defaults to unbiased)."""
    w = weight.float()
    mean = w.mean(dim=(1, 2), keepdim=True)
    var = w.var(dim=(1, 2), keepdim=True, unbiased=False)
    return (w - mean) * torch.rsqrt(var + eps)


class WSConv1d(nn.Conv1d):
    """Weight-standardized 1-D convolution (eps 1e-5 for fp32 weights,
    1e-3 otherwise, as in the JAX package)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        eps = 1e-5 if self.weight.dtype == torch.float32 else 1e-3
        w = standardize_conv_weight(self.weight, eps).to(x.dtype)
        return F.conv1d(x, w, self.bias, self.stride, self.padding)


class ChannelLayerNorm(nn.Module):
    """Gain-only LayerNorm over the channel axis, per position.

    eps follows the flax module: 1e-5 for float32 inputs, 1e-3 otherwise.
    The kernel path always uses 1e-5 (see ``stacked_cuda``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, dim, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        eps = 1e-5 if x.dtype == torch.float32 else 1e-3
        var = x.var(dim=1, unbiased=False, keepdim=True)
        mean = x.mean(dim=1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + eps) * self.g


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


def film_scale_shift(x, scale, shift):
    """FiLM on ``x [B, C, L]``. ``scale [B, C]``: ``x*(scale+1)+shift``;
    multi-channel ``scale [B, E, C]``: ``x*(sum_e scale_e + E) + sum_e shift_e``."""
    if scale.ndim == 2:
        return x * (scale[:, :, None] + 1.0) + shift[:, :, None]
    if scale.ndim == 3:
        e = scale.shape[1]
        return x * (scale.sum(1)[:, :, None] + float(e)) + shift.sum(1)[:, :, None]
    raise ValueError(f"Unsupported FiLM scale ndim: {scale.ndim}")


class Block1D(nn.Module):
    """WSConv(k=3) -> GroupNorm -> FiLM -> SiLU."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8):
        super().__init__()
        self.proj = WSConv1d(dim, dim_out, 3, padding=1)
        self.norm = nn.GroupNorm(groups, dim_out, eps=1e-5)

    def forward(self, x, scale_shift: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        x = self.norm(self.proj(x))
        if scale_shift is not None:
            x = film_scale_shift(x, *scale_shift)
        return F.silu(x)


class ResnetBlock1D(nn.Module):
    """Two FiLM blocks + residual; the embedding goes SiLU -> Linear and
    conditions the first block only."""

    def __init__(self, dim: int, dim_out: int, emb_dim: Optional[int] = None,
                 groups: int = 8):
        super().__init__()
        self.mlp = (
            nn.Sequential(nn.SiLU(), nn.Linear(emb_dim, dim_out * 2))
            if emb_dim is not None else None
        )
        self.block1 = Block1D(dim, dim_out, groups)
        self.block2 = Block1D(dim_out, dim_out, groups)
        self.res_conv = nn.Conv1d(dim, dim_out, 1) if dim != dim_out else nn.Identity()

    def forward(self, x, emb: Optional[torch.Tensor] = None):
        scale_shift = None
        if self.mlp is not None and emb is not None:
            scale_shift = self.mlp(emb).chunk(2, dim=-1)
        h = self.block1(x, scale_shift)
        h = self.block2(h)
        return h + self.res_conv(x)


class LinearAttention1D(nn.Module):
    """Softmax-kernel linear attention over the length axis: q softmaxed
    over the head channels, k over the positions."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv1d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Sequential(nn.Conv1d(hidden, dim, 1), ChannelLayerNorm(dim))

    def forward(self, x):
        B, _, L = x.shape
        q, k, v = (
            t.reshape(B, self.heads, self.dim_head, L)
            for t in self.to_qkv(x).chunk(3, dim=1)
        )
        q = q.softmax(dim=-2) * (self.dim_head ** -0.5)
        k = k.softmax(dim=-1)
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhde,bhdn->bhen", context, q)
        return self.to_out(out.reshape(B, -1, L))
