"""Kernel path for the VAE grasp decoder.

Counterpart of :mod:`graspldm_tpu.models.fast_decoder`. The decoder core is
a plain conditional ResNet1D (no time head) at L = 16; it runs through the
stage kernels (:mod:`.stacked_cuda`: four ``stage_kernel`` launches and one
``final_kernel``), or, with attention between launches
(``stacked_cuda.XLA_ATTENTION``), through four ``hybrid_stage_kernel``
launches, the attention in plain PyTorch after each, and one
``hybrid_final_kernel``: ``stacked_denoiser_apply`` picks the chain, as
the JAX package's ``decoder_fast_apply`` does (``fast_decoder.py:83``).
The in-layer ``Linear(latent -> L)`` and the output heads stay plain
PyTorch around the kernels, as they stay XLA in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .stacked_cuda import PackedNet, stacked_denoiser_apply
from .stacked_denoiser import DenoiserDims, compute_input_emb, pack_math_weights

__all__ = ["decoder_dims_for", "pack_decoder_weights", "decoder_fast_apply"]


def decoder_dims_for(vae) -> DenoiserDims:
    """Kernel dims of a GraspCVAE's decoder core."""
    R = vae.intermediate_feature_resolution
    return DenoiserDims(
        seq_len=R, block_channels=tuple(vae.block_channels),
        groups=vae.resnet_block_groups, emb_dim=R * 4,
        cond_channels=vae.pc_latent_channels, cond_dim=vae.pc_latent_size,
        fourier_dim=16,  # unused: the decoder has no time head
    )


@torch.no_grad()
def pack_decoder_weights(vae, dims: DenoiserDims, dtype=torch.float32, device=None) -> PackedNet:
    """GraspCVAE -> kernel operands of the decoder core, plus the float32
    in-layer and heads in ``aux``; no ``device`` named: the decoder's."""
    dec = vae.decoder
    w = PackedNet(pack_math_weights(dec.net, dims), dims, dtype, device)
    heads = {
        "dec_in_w": dec.in_layer.weight.t(), "dec_in_b": dec.in_layer.bias,
        "head_tmrp_w": dec.tmrp.weight.t(), "head_tmrp_b": dec.tmrp.bias,
        "head_class_w": dec.class_logits.weight.t(), "head_class_b": dec.class_logits.bias,
    }
    if dec.qualities is not None:
        heads["head_q_w"], heads["head_q_b"] = dec.qualities.weight.t(), dec.qualities.bias
    w.aux.update({k: v.detach().float().contiguous().to(w.device) for k, v in heads.items()})
    return w


def decoder_fast_apply(w: PackedNet, z_h: torch.Tensor, z_pc: torch.Tensor,
                       input_emb: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """``(z_h [BG, D], z_pc [BG, Ce, Dpc]) -> (tmrp, cls_logits[, qualities])``,
    equal to ``GraspCVAE.decode``."""
    a = w.aux
    x = z_h.float() @ a["dec_in_w"] + a["dec_in_b"]  # [BG, L]
    if input_emb is None:
        input_emb = compute_input_emb(a, z_pc)
    out = stacked_denoiser_apply(w, x[:, None, :], None, z_pc, input_emb)[:, 0, :].float()
    res = (out @ a["head_tmrp_w"] + a["head_tmrp_b"], out @ a["head_class_w"] + a["head_class_b"])
    if "head_q_w" in a:
        res = res + (out @ a["head_q_w"] + a["head_q_b"],)
    return res
