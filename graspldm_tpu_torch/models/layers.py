"""Shared 1-D network building blocks (torch, channel-first ``[B, C, L]``).

Counterpart of :mod:`graspldm_tpu.models.layers`. Module and parameter
names follow the reference PyTorch key space that
:mod:`graspldm_tpu.utils.torch_convert` reads, so a port ``state_dict``
converts straight into JAX variables and back (:mod:`..utils.convert`).

The blocks take an optional compute ``dtype`` in ``forward`` (``None``:
float32, the modules as they are). Given one, they round where the flax
modules declared with ``dtype=...`` round: every Dense / Conv casts input,
weight and bias to it (:func:`cast_apply`), ``WSConv1d`` standardises in
float32 first, GroupNorm takes float32 statistics and rounds its output
(:func:`cast_group_norm`), the attention's products accumulate in
float32, and ``ChannelLayerNorm`` (no dtype in flax) computes in its
input's dtype and promotes to float32 through its gain.
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
    "Attention1D",
    "PreNorm",
    "Residual",
    "cast_apply",
    "film_scale_shift",
    "cast_group_norm",
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


def cast_apply(layer: nn.Module, x: torch.Tensor,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``layer(x)`` for a Linear, Conv1d or Identity. Given ``dtype``, as
    flax's ``nn.Dense`` / ``nn.Conv(dtype=...)``: input, weight and bias cast
    to ``dtype``, the product rounded to it, then the bias added in it."""
    if dtype is None or isinstance(layer, nn.Identity):
        return layer(x)
    w = layer.weight.to(dtype)
    if isinstance(layer, nn.Linear):
        y, b = F.linear(x.to(dtype), w), layer.bias
    else:
        y, b = layer._conv_forward(x.to(dtype), w, None), layer.bias
        b = None if b is None else b[:, None]
    return y if b is None else y + b.to(dtype)


def cast_group_norm(norm: nn.GroupNorm, x: torch.Tensor,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``norm(x)`` on ``x [B, C, L]``. Given ``dtype``, as flax's
    ``nn.GroupNorm(dtype=...)``: float32 statistics (``E[x^2] - E[x]^2``,
    clipped at 0), the affine in float32, the result rounded to ``dtype``."""
    if dtype is None:
        return norm(x)
    B, C = x.shape[:2]
    xf = x.float()
    grp = xf.reshape(B, norm.num_groups, -1)
    mean = grp.mean(-1, keepdim=True)
    var = ((grp * grp).mean(-1, keepdim=True) - mean * mean).clamp(min=0.0)
    rep = C // norm.num_groups
    mean, var = mean.repeat_interleave(rep, 1), var.repeat_interleave(rep, 1)
    mul = torch.rsqrt(var + norm.eps) * norm.weight[:, None]
    return ((xf - mean) * mul + norm.bias[:, None]).to(dtype)


class WSConv1d(nn.Conv1d):
    """Weight-standardized 1-D convolution (eps 1e-5 for fp32 weights,
    1e-3 otherwise, as in the JAX package). The weight is standardised in
    float32 before any cast to the compute ``dtype``."""

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        eps = 1e-5 if self.weight.dtype == torch.float32 else 1e-3
        w = standardize_conv_weight(self.weight, eps)
        if dtype is None:
            return F.conv1d(x, w.to(x.dtype), self.bias, self.stride, self.padding)
        y = F.conv1d(x.to(dtype), w.to(dtype), None, self.stride, self.padding)
        return y + self.bias.to(dtype)[:, None]


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

    def forward(self, x, **kw):
        return self.fn(self.norm(x), **kw)


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x, **kw):
        return self.fn(x, **kw) + x


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

    def forward(self, x, scale_shift: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                dtype: Optional[torch.dtype] = None):
        x = cast_group_norm(self.norm, self.proj(x, dtype), dtype)
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

    def forward(self, x, emb: Optional[torch.Tensor] = None,
                dtype: Optional[torch.dtype] = None):
        scale_shift = None
        if self.mlp is not None and emb is not None:
            scale_shift = cast_apply(self.mlp[1], F.silu(emb), dtype).chunk(2, dim=-1)
        h = self.block1(x, scale_shift, dtype)
        h = self.block2(h, None, dtype)
        return h + cast_apply(self.res_conv, x, dtype)


class LinearAttention1D(nn.Module):
    """Softmax-kernel linear attention over the length axis: q softmaxed
    over the head channels, k over the positions."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv1d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Sequential(nn.Conv1d(hidden, dim, 1), ChannelLayerNorm(dim))

    def forward(self, x, dtype: Optional[torch.dtype] = None):
        B, _, L = x.shape
        q, k, v = (
            t.reshape(B, self.heads, self.dim_head, L)
            for t in cast_apply(self.to_qkv, x, dtype).chunk(3, dim=1)
        )
        q = q.softmax(dim=-2) * (self.dim_head ** -0.5)
        k = k.softmax(dim=-1)
        q, k, v = q.float(), k.float(), v.float()  # the products accumulate in float32
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhde,bhdn->bhen", context, q).reshape(B, -1, L)
        return self.to_out[1](cast_apply(self.to_out[0], out, dtype))


class Attention1D(nn.Module):
    """Full softmax attention over the length axis, ``[B, C, L] -> [B, C, L]``
    (no residual, no norm). Counterpart of the JAX package's
    ``layers.Attention1D``: q scaled by ``dim_head ** -0.5`` in the compute
    dtype, the ``sim`` and ``out`` products accumulated in float32 and cast
    back to the input's dtype, the softmax in float32."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv1d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Conv1d(hidden, dim, 1)

    def forward(self, x, dtype: Optional[torch.dtype] = None):
        B, _, L = x.shape
        q, k, v = (
            t.reshape(B, self.heads, self.dim_head, L)
            for t in cast_apply(self.to_qkv, x, dtype).chunk(3, dim=1)
        )
        q = q * (self.dim_head ** -0.5)
        sim = torch.einsum("bhdi,bhdj->bhij", q.float(), k.float())
        attn = sim.softmax(dim=-1).to(x.dtype)
        out = torch.einsum("bhij,bhdj->bhdi", attn.float(), v.float()).to(x.dtype)
        return cast_apply(self.to_out, out.reshape(B, -1, L), dtype)
