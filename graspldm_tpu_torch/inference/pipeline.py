"""Generation pipelines: point clouds -> grasp poses (torch).

Counterpart of :mod:`graspldm_tpu.inference.pipeline` for the unguided
paths: encode the cloud once (PVCNN, plain PyTorch), sample ``num_grasps``
latents (from N(0, I), or by reverse diffusion in one
``ddim_sampler_kernel`` launch), decode them through the stage kernels,
unnormalize, convert tmrp -> 4x4 transforms and sigmoid the success logit.

The kernels run wherever the tensors live: on a CUDA device the
hand-written kernels launch, on the CPU their plain PyTorch versions run.
Guidance, classifier-free guidance, class/region conditioning, EDM
samplers and trajectory decoding are not ported yet and raise.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..diffusion import GaussianDiffusion1D
from ..models.cuda_sampler import fused_sample
from ..models.fast_decoder import decoder_dims_for, decoder_fast_apply, pack_decoder_weights
from ..models.stacked_cuda import PackedNet
from ..models.stacked_denoiser import DenoiserDims, compute_input_emb, pack_math_weights
from ..utils.normalization import NormalizationMeta, unnormalize_grasps
from ..utils.rotations import tmrp_to_H

__all__ = [
    "GenerationWeights",
    "pack_generation_weights",
    "decode_and_postprocess",
    "vae_generate",
    "ldm_generate",
]


class GenerationWeights(NamedTuple):
    """Kernel operands of the decoder (and denoiser), packed once per model."""

    decoder: PackedNet
    denoiser: Optional[PackedNet]


def _denoiser_dims(ddm) -> DenoiserDims:
    return DenoiserDims(
        seq_len=ddm.latent_in_features,
        block_channels=tuple(ddm.block_channels),
        groups=ddm.resnet_block_groups,
        emb_dim=ddm.latent_in_features * 4,
        cond_channels=3,
        cond_dim=ddm.pc_latent_size,
        fourier_dim=ddm.learned_sinusoidal_dim,
    )


def _kernel_dtype(d) -> torch.dtype:
    return torch.bfloat16 if d == torch.bfloat16 else torch.float32


@torch.no_grad()
def pack_generation_weights(vae, ddm=None, device=None) -> GenerationWeights:
    """Pack the decoder (and denoiser) at their declared compute dtypes."""
    dec = pack_decoder_weights(
        vae, decoder_dims_for(vae), _kernel_dtype(vae.decoder_dtype), device
    )
    den = None
    if ddm is not None:
        if not ddm.random_fourier_features:
            raise NotImplementedError("the kernel path takes random Fourier time features")
        dims = _denoiser_dims(ddm)
        den = PackedNet(pack_math_weights(ddm, dims), dims, _kernel_dtype(ddm.dtype), device)
    return GenerationWeights(dec, den)


def decode_and_postprocess(
    weights: GenerationWeights, z_h: torch.Tensor, z_pc_rep: torch.Tensor,
    num_grasps: int, meta: Optional[NormalizationMeta],
) -> Dict[str, torch.Tensor]:
    """Decode latents to world-frame grasps: ``grasps [B, G, 4, 4]``,
    ``grasp_tmrp [B, G, 6]``, ``confidence [B, G]``[, ``qualities``]."""
    out = decoder_fast_apply(weights.decoder, z_h, z_pc_rep)
    tmrp_n, cls_logits = out[0], out[1]
    B = z_pc_rep.shape[0] // num_grasps
    tmrp = tmrp_n.reshape(B, num_grasps, 6)
    if meta is not None:
        tmrp = unnormalize_grasps(tmrp, meta)
    result = {
        "grasps": tmrp_to_H(tmrp),
        "grasp_tmrp": tmrp,
        "confidence": torch.sigmoid(cls_logits.reshape(B, num_grasps)),
    }
    if len(out) > 2:
        result["qualities"] = out[2].reshape(B, num_grasps, -1)
    return result


@torch.no_grad()
def vae_generate(
    vae, pc: torch.Tensor, num_grasps: int, generator: Optional[torch.Generator] = None,
    meta: Optional[NormalizationMeta] = None, z_h: Optional[torch.Tensor] = None,
    weights: Optional[GenerationWeights] = None,
) -> Dict[str, torch.Tensor]:
    """VAE-mode generation: latents from the N(0, I) prior.

    Args:
        pc: ``[B, N, 3]`` normalized clouds. ``z_h [B*G, latent]`` overrides
            the prior draw (tests inject JAX's).
    """
    weights = weights or pack_generation_weights(vae, device=pc.device)
    z_pc = vae.encode_pc(pc)
    z_pc_rep = z_pc.repeat_interleave(num_grasps, dim=0)
    if z_h is None:
        z_h = torch.randn((pc.shape[0] * num_grasps, vae.grasp_latent_size),
                          generator=generator, device=pc.device)
    return decode_and_postprocess(weights, z_h, z_pc_rep, num_grasps, meta)


@torch.no_grad()
def ldm_generate(
    vae, ddm, diffusion: GaussianDiffusion1D, pc: torch.Tensor, num_grasps: int,
    generator: Optional[torch.Generator] = None, num_inference_steps: int = 100,
    sampler: str = "ddim", meta: Optional[NormalizationMeta] = None,
    x_T: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
    weights: Optional[GenerationWeights] = None, return_trajectory: bool = False,
    cls_cond=None, region_points=None, cfg_scale=None, guidance_scale=None,
    guidance_fn=None,
) -> Dict[str, torch.Tensor]:
    """LDM-mode generation: reverse diffusion in the grasp latent space.

    The whole sampler runs in one ``ddim_sampler_kernel`` launch (DDIM or
    DDPM). ``x_T [B*G, latent]`` and the DDPM ``noise [S, B*G, latent]``
    default to draws from ``generator``; tests inject JAX's.
    """
    unported = {
        "return_trajectory": return_trajectory, "cls_cond": cls_cond is not None,
        "region_points": region_points is not None, "cfg_scale": cfg_scale is not None,
        "guidance_scale": guidance_scale is not None, "guidance_fn": guidance_fn is not None,
    }
    if any(unported.values()):
        raise NotImplementedError(
            f"not ported yet: {[k for k, v in unported.items() if v]}"
        )
    if sampler not in ("ddim", "ddpm"):
        raise NotImplementedError(f"sampler {sampler!r} is not ported yet")
    weights = weights or pack_generation_weights(vae, ddm, device=pc.device)
    z_pc = vae.encode_pc(pc)
    z_pc_rep = z_pc.repeat_interleave(num_grasps, dim=0)
    BG = z_pc_rep.shape[0]
    if x_T is None:
        x_T = torch.randn((BG, ddm.latent_in_features), generator=generator, device=pc.device)
    input_emb = compute_input_emb(weights.denoiser.aux, z_pc_rep)
    x0 = fused_sample(
        weights.denoiser, diffusion.schedule, input_emb, x_T,
        num_inference_steps=num_inference_steps, sampler=sampler,
        variance_type=diffusion.variance_type, noise=noise, generator=generator,
    )
    return decode_and_postprocess(weights, x0[:, 0, :], z_pc_rep, num_grasps, meta)
