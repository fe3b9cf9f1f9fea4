"""Denoiser/decoder weight packing and the embedding helpers around the kernels.

Counterpart of the helpers of :mod:`graspldm_tpu.models.stacked_denoiser`
(``compute_time_emb``, ``compute_input_emb``, ``compute_emb_s_stacked``)
plus :func:`pack_math_weights`, which turns a ResNet1D core's parameters
into the kernels' operands in their *math* form: weight-standardized k3
conv taps as ``[3*Cin, Cout]`` matrices (standardized once, as
``graspldm_tpu/models/fused_denoiser.py:_standardize`` does), GroupNorm
gain/shift, the FiLM dense ``[emb, 2C]``, qkv ``[C, 3*h*d]``, out-projection
``[h*d, C]`` and LayerNorm gains. The TPU forms (banded ``[L*Cin, L*Cout]``
matrices, one-hot pooling matrices, lane tiling) are not carried over.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import standardize_conv_weight

__all__ = [
    "DenoiserDims",
    "FLAGSHIP_DIMS",
    "pack_math_weights",
    "compute_time_emb",
    "compute_input_emb",
    "compute_emb_s_stacked",
]


class DenoiserDims(NamedTuple):
    seq_len: int  # L (4 for the flagship denoiser, 16 for the VAE decoder)
    block_channels: Tuple[int, ...]  # (32, 64, 128, 256)
    groups: int  # GroupNorm groups (4)
    emb_dim: int  # L * 4
    cond_channels: int  # Ce = 3
    cond_dim: int  # 64
    fourier_dim: int  # 16
    heads: int = 4
    dim_head: int = 32

    @property
    def cins(self) -> Tuple[int, ...]:
        """Input width of each stage: the init conv emits L channels."""
        return (self.seq_len,) + tuple(self.block_channels[:-1])


FLAGSHIP_DIMS = DenoiserDims(
    seq_len=4, block_channels=(32, 64, 128, 256), groups=4, emb_dim=16,
    cond_channels=3, cond_dim=64, fourier_dim=16,
)


def _linear_t(lin: torch.nn.Linear) -> torch.Tensor:
    return lin.weight.detach().float().t().contiguous()  # [in, out]


def _conv3_matrix(w: torch.Tensor) -> torch.Tensor:
    """torch conv weight ``[Cout, Cin, 3]`` -> ``[3*Cin, Cout]``, row ``t*Cin + c``."""
    return w.permute(2, 1, 0).reshape(-1, w.shape[0]).contiguous()


@torch.no_grad()
def pack_math_weights(net, dims: DenoiserDims) -> Dict[str, torch.Tensor]:
    """A ResNet1D / TimeConditionedResNet1D core -> float32 kernel operands."""
    if any(m.res_conv.__class__ is not torch.nn.Identity
           for m in [*(b[j] for b in net.blocks for j in (0, 1)), net.final_res_block]):
        raise ValueError("width-changing ResnetBlocks are not produced by this core")
    if dims.heads != 4 or dims.dim_head != 32:
        raise ValueError("the kernels take 4 heads of 32 channels")
    w: Dict[str, torch.Tensor] = {}
    time_mlp = getattr(net, "time_mlp", None)
    if time_mlp is not None:
        w["fourier_w"] = time_mlp[0].weights.detach().float()
        w["time_w1"], w["time_b1"] = _linear_t(time_mlp[1]), time_mlp[1].bias.float()
        w["time_w2"], w["time_b2"] = _linear_t(time_mlp[3]), time_mlp[3].bias.float()
    lin = net.input_emb_layers[0]
    w["input_w"], w["input_b"] = _linear_t(lin), lin.bias.float()
    w["init_w"] = net.init_conv.weight.float()[:, 0, :].t().contiguous()  # [7, dim0]
    w["init_b"] = net.init_conv.bias.float()

    def resblock(pfx, blk):
        w[f"{pfx}_mlp_w"] = _linear_t(blk.mlp[1])  # [E, 2C]
        w[f"{pfx}_mlp_b"] = blk.mlp[1].bias.float()
        for j, b in ((1, blk.block1), (2, blk.block2)):
            # weight standardization is baked in (it depends only on params)
            w[f"{pfx}_w{j}"] = _conv3_matrix(standardize_conv_weight(b.proj.weight))
            w[f"{pfx}_b{j}"] = b.proj.bias.float()
            w[f"{pfx}_g{j}"] = b.norm.weight.float()
            w[f"{pfx}_be{j}"] = b.norm.bias.float()

    for i, (res1, res2, attn, proj) in enumerate(net.blocks):
        resblock(f"b{i}r1", res1)
        resblock(f"b{i}r2", res2)
        la = attn.fn.fn
        w[f"b{i}_attn_g"] = attn.fn.norm.g.float().reshape(-1)
        w[f"b{i}_wqkv"] = la.to_qkv.weight.float()[:, :, 0].t().contiguous()  # [C, 3hd]
        w[f"b{i}_wo"] = la.to_out[0].weight.float()[:, :, 0].t().contiguous()  # [hd, C]
        w[f"b{i}_bo"] = la.to_out[0].bias.float()
        w[f"b{i}_out_g"] = la.to_out[1].g.float().reshape(-1)
        w[f"b{i}_wp"] = _conv3_matrix(proj.weight.float())
        w[f"b{i}_bp"] = proj.bias.float()
    resblock("final", net.final_res_block)
    w["final_fw"] = net.final_conv.weight.float()[0, :, 0].contiguous()  # [C]
    w["final_fb"] = net.final_conv.bias.float()
    return {k: v.detach().contiguous() for k, v in w.items()}


def compute_time_emb(w: Dict[str, torch.Tensor], t: torch.Tensor) -> torch.Tensor:
    """Per-sample time embedding ``[B, emb]`` (random Fourier + MLP), fp32."""
    tf = t.float()[:, None]
    freqs = tf * w["fourier_w"][None, :] * (2.0 * math.pi)
    t_feat = torch.cat([tf, freqs.sin(), freqs.cos()], dim=-1)
    t_emb = F.gelu(t_feat @ w["time_w1"] + w["time_b1"])
    return t_emb @ w["time_w2"] + w["time_b2"]


def compute_input_emb(w: Dict[str, torch.Tensor], z_cond: torch.Tensor) -> torch.Tensor:
    """Conditioning embedding ``[B, Ce, emb]``; constant across sampler steps."""
    return F.silu(z_cond.float() @ w["input_w"] + w["input_b"])


def compute_emb_s_stacked(w, t: Optional[torch.Tensor], z_cond=None, input_emb=None):
    """FiLM input ``silu(time_emb + input_emb)`` flattened to ``[B, Ce*emb]``
    (``t=None``: the non-temporal decoder core, ``silu(input_emb)``)."""
    if input_emb is None:
        input_emb = compute_input_emb(w, z_cond)
    latent = input_emb if t is None else compute_time_emb(w, t)[:, None, :] + input_emb
    return F.silu(latent).reshape(latent.shape[0], -1)
