"""Generation pipelines: point clouds -> grasp poses (torch).

Counterpart of :mod:`graspldm_tpu.inference.pipeline`: encode the cloud
once (PVCNN, plain PyTorch), sample ``num_grasps`` latents (from N(0, I),
or by reverse diffusion), decode them through the stage kernels,
unnormalize, convert tmrp -> 4x4 transforms and sigmoid the success logit.

Reverse diffusion takes one of two routes, as in the JAX package:

* unguided (class / region conditioning included: its embedding is
  constant across steps and folds into the conditioning embedding): one
  sampler-kernel launch, ``ddim_sampler_kernel`` for DDIM/DDPM,
  ``dpmpp_sampler_kernel`` or ``churn_sampler_kernel`` for EDM; with
  ``return_trajectory`` one per-step kernel launch per step instead;
* guided (``cfg_scale``, ``guidance_scale`` or ``guidance_fn``): the
  Python-loop samplers, whose per-step guidance work (the CFG combine, the
  decoder VJP) runs between denoiser evaluations, each one ``full_kernel``
  launch (:func:`..models.stacked_cuda.stacked_denoiser_apply` with
  ``fuse_stages=True``).

With ``return_trajectory`` up to 50 of the sampler's states are decoded
too. The kernels run wherever the tensors live: on a CUDA device the
hand-written kernels launch, on the CPU their plain PyTorch versions run.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Union

import torch

from ..diffusion import ElucidatedDiffusion, GaussianDiffusion1D, make_success_guidance
from ..models.cuda_sampler import fused_sample, fused_sample_churn, fused_sample_dpmpp
from ..models.fast_decoder import decoder_dims_for, decoder_fast_apply, pack_decoder_weights
from ..models.stacked_cuda import PackedNet, stacked_denoiser_apply
from ..models.stacked_denoiser import (
    DenoiserDims,
    compute_extra_emb,
    compute_input_emb,
    pack_math_weights,
)
from ..utils.normalization import NormalizationMeta, unnormalize_grasps
from ..utils.rotations import tmrp_to_H

__all__ = [
    "GenerationWeights",
    "pack_generation_weights",
    "decode_and_postprocess",
    "trajectory_decode_indices",
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


def _check_denoiser(ddm, cond_kwargs: dict) -> None:
    """The JAX package's rules for its kernel paths
    (``pipeline.py:_resolve_denoiser_impl``): an unconditioned denoiser
    takes no condition, a class- or region-conditioned one exactly its
    own; z4 / z16 latents; random Fourier time features."""
    want = {None: set(), "class": {"cls_cond"}, "region": {"region_points"}}
    if (set(cond_kwargs) != want[ddm.conditioning]
            or ddm.latent_in_features not in (4, 16) or not ddm.random_fourier_features):
        raise ValueError(
            "the kernel path supports GraspLatentDDM (z4/z16, random Fourier time "
            "embedding), ClassConditionedGraspLatentDDM with cls_cond, or "
            "RegionConditionedGraspLatentDDM with region_points"
        )


def _guided_denoise_fn(w: PackedNet, input_emb: torch.Tensor, extra: Optional[torch.Tensor],
                       cfg_scale: Optional[float]):
    """``denoise(x [BG, 1, L], t [BG], z) -> eps`` (float32) for the
    Python-loop samplers: one ``full_kernel`` launch per call.

    ``input_emb [BG, Ce, E]`` is hoisted out of the loop with the extra
    embedding folded in. With ``cfg_scale`` each call runs a doubled batch:
    rows ``[:BG]`` conditioned, rows ``[BG:]`` with the extra embedding
    zeroed (the null condition, ``cond_mask = 0``), combined as ``e_u + w
    (e_c - e_u)`` in float32 (``pipeline.py:_make_cfg_denoise_fn``)."""
    if cfg_scale is None:
        ie = input_emb if extra is None else input_emb + extra[:, None, :]

        def denoise(x, t, z):
            return stacked_denoiser_apply(w, x, t, None, ie, fuse_stages=True).float()

        return denoise
    BG = input_emb.shape[0]
    ie2 = torch.cat([input_emb + extra[:, None, :], input_emb])

    def denoise(x, t, z):
        eps2 = stacked_denoiser_apply(w, torch.cat([x, x]), torch.cat([t, t]), None, ie2,
                                      fuse_stages=True).float()
        e_c, e_u = eps2[:BG], eps2[BG:]
        return e_u + cfg_scale * (e_c - e_u)

    return denoise


@torch.no_grad()
def pack_generation_weights(vae, ddm=None, device=None) -> GenerationWeights:
    """Pack the decoder (and denoiser) at their declared compute dtypes (a
    class- or region-conditioned denoiser declares none: float32)."""
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


def trajectory_decode_indices(n_states: int) -> torch.Tensor:
    """Which of ``n_states`` trajectory states are decoded: ``num = min(50,
    n)`` evenly spaced indices, ``floor(i * (n - 1) / (num - 1))``, the
    JAX package's ``jnp.linspace(0, n - 1, num).astype(jnp.int32)``
    (``pipeline.py:_finish_ldm``) in exact integer arithmetic.

    Truncating a float32 linspace puts an index one too low wherever the
    quotient is whole but its float32 value lands just below it: XLA's
    float32 division on the CPU does so at some n (e.g. n = 42 gives index
    2 for i = 3), IEEE float32 at others (n = 23). Integer arithmetic
    equals JAX's indices at every n the samplers produce for the step
    counts in use (100 DDIM / churn steps: n = 101; 32 DPM++: n = 32)."""
    num = min(50, n_states)
    i = torch.arange(num, dtype=torch.int64)
    return i * (n_states - 1) // max(num - 1, 1)


@torch.no_grad()
def vae_generate(
    vae, pc: torch.Tensor, num_grasps: int, generator: Optional[torch.Generator] = None,
    meta: Optional[NormalizationMeta] = None, z_h: Optional[torch.Tensor] = None,
    weights: Optional[GenerationWeights] = None,
) -> Dict[str, torch.Tensor]:
    """VAE-mode generation: latents from the N(0, I) prior. Runs on the
    device of ``pc`` and of the models (the caller puts them there).

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
    vae, ddm, diffusion: Union[GaussianDiffusion1D, ElucidatedDiffusion], pc: torch.Tensor,
    num_grasps: int,
    generator: Optional[torch.Generator] = None, num_inference_steps: int = 100,
    sampler: str = "ddim", meta: Optional[NormalizationMeta] = None,
    x_T: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
    weights: Optional[GenerationWeights] = None, return_trajectory: bool = False,
    cls_cond=None, region_points=None, cfg_scale: Optional[float] = None,
    guidance_scale: Optional[float] = None, guidance_fn=None,
) -> Dict[str, torch.Tensor]:
    """LDM-mode generation: reverse diffusion in the grasp latent space.
    Runs on the device of ``pc`` and of the models (the caller puts them
    there).

    Unguided, without ``return_trajectory`` the whole sampler runs in one
    kernel launch. With a
    ``GaussianDiffusion1D``: ``ddim_sampler_kernel`` (``sampler`` "ddim" or
    "ddpm"). With an ``ElucidatedDiffusion``: ``sampler == "dpmpp"`` runs
    DPM-Solver++(2M) (``dpmpp_sampler_kernel``), any other value the
    stochastic churn sampler (``churn_sampler_kernel``), as the JAX
    package routes them. ``x_T [B*G, latent]`` (EDM: at sigma_max scale)
    and the DDPM / churn ``noise [S, B*G, latent]`` (unit normals) default
    to draws from ``generator``; tests inject JAX's.

    With ``return_trajectory`` the sampler launches its per-step kernel
    once per step (``ddim_step_kernel``, ``dpmpp_step_kernel`` or
    ``churn_step_kernel``), and the result also holds, as the JAX package's
    does (``pipeline.py:_finish_ldm``), ``latent_trajectory`` (DDIM/DDPM
    ``[len(grid) + 1, B*G, 1, latent]`` and churn ``[N + 1, ...]`` with x_T
    first, DPM++ ``[N, ...]`` without it) and ``all_diffusion_grasps
    [S'', B, G, 4, 4]``: the states at :func:`trajectory_decode_indices`,
    decoded one at a time as x_0 is.

    Conditioning and guidance (``graspldm_tpu.diffusion.guidance``):

    * ``cls_cond [B*G]`` (scalars) or ``region_points [B*G, P, 3]`` for a
      class- or region-conditioned denoiser (exactly its own condition;
      anything else raises ``ValueError``);
    * ``cfg_scale``: classifier-free guidance weight ``w`` (a conditioned
      denoiser only): one doubled-batch evaluation per denoiser call;
    * ``guidance_scale``: success guidance, each step's x0 estimate moved
      uphill on the decoder's ``log p(success | z_h, z_pc)`` (one decoder
      VJP per denoiser call); ``guidance_fn`` replaces that gradient with
      a custom ``x0 [BG, 1, D] -> grad`` hook (scaled by
      ``guidance_scale``, default 1). The two compose with CFG.

    Any of the three runs the Python-loop sampler with one ``full_kernel``
    launch per denoiser evaluation (DDIM/DDPM: one per step; DPM++: N;
    churn: 2N - 1); the draws from ``generator`` are the same as on the
    unguided path.
    """
    edm = isinstance(diffusion, ElucidatedDiffusion)
    if not edm and sampler not in ("ddim", "ddpm"):
        raise ValueError(f"sampler {sampler!r} needs an ElucidatedDiffusion; "
                         "GaussianDiffusion1D takes 'ddim' or 'ddpm'")
    cond_kwargs = {k: torch.as_tensor(v, device=pc.device)
                   for k, v in (("cls_cond", cls_cond), ("region_points", region_points))
                   if v is not None}
    _check_denoiser(ddm, cond_kwargs)
    if cfg_scale is not None and not cond_kwargs:
        raise ValueError("cfg_scale requires a conditioned denoiser (cls_cond or region_points)")
    weights = weights or pack_generation_weights(vae, ddm, device=pc.device)
    z_pc = vae.encode_pc(pc)
    z_pc_rep = z_pc.repeat_interleave(num_grasps, dim=0)
    BG = z_pc_rep.shape[0]
    if x_T is None:
        x_T = torch.randn((BG, ddm.latent_in_features), generator=generator, device=pc.device)
        if edm:
            x_T = diffusion.sample_schedule(num_inference_steps)[0].item() * x_T
    input_emb = compute_input_emb(weights.denoiser.aux, z_pc_rep)
    extra = compute_extra_emb(weights.denoiser.aux, **cond_kwargs)
    if guidance_fn is None and guidance_scale is not None:
        guidance_fn = make_success_guidance(vae, z_pc_rep)
    if guidance_fn is not None or cfg_scale is not None:
        res = _guided_sample(weights.denoiser, diffusion, input_emb, extra, x_T, noise,
                             generator, num_inference_steps, sampler, return_trajectory,
                             cfg_scale, guidance_fn,
                             1.0 if guidance_scale is None else float(guidance_scale))
    else:
        if extra is not None:
            input_emb = input_emb + extra[:, None, :]
        res = _fused_sample(weights.denoiser, diffusion, input_emb, x_T, noise, generator,
                            num_inference_steps, sampler, return_trajectory)
    x0, traj = res if return_trajectory else (res, None)
    result = decode_and_postprocess(weights, x0[:, 0, :], z_pc_rep, num_grasps, meta)
    if return_trajectory:
        result["latent_trajectory"] = traj
        result["all_diffusion_grasps"] = torch.stack([
            decode_and_postprocess(weights, traj[i, :, 0, :], z_pc_rep, num_grasps, meta)["grasps"]
            for i in trajectory_decode_indices(traj.shape[0]).tolist()
        ])
    return result


def _fused_sample(w: PackedNet, diffusion, input_emb, x_T, noise, generator,
                  num_inference_steps: int, sampler: str, return_trajectory: bool):
    """The unguided sampler: one whole-trajectory kernel launch, or one
    per-step kernel launch per step."""
    if isinstance(diffusion, ElucidatedDiffusion) and sampler == "dpmpp":
        return fused_sample_dpmpp(w, diffusion, input_emb, x_T,
                                  num_sample_steps=num_inference_steps,
                                  return_trajectory=return_trajectory)
    if isinstance(diffusion, ElucidatedDiffusion):
        return fused_sample_churn(w, diffusion, input_emb, x_T,
                                  num_sample_steps=num_inference_steps, noise=noise,
                                  generator=generator, return_trajectory=return_trajectory)
    return fused_sample(
        w, diffusion.schedule, input_emb, x_T, num_inference_steps=num_inference_steps,
        sampler=sampler, variance_type=diffusion.variance_type, noise=noise,
        generator=generator, return_trajectory=return_trajectory,
    )


def _guided_sample(w: PackedNet, diffusion, input_emb, extra, x_T, noise, generator,
                   num_inference_steps: int, sampler: str, return_trajectory: bool,
                   cfg_scale, guidance_fn, guidance_scale: float):
    """The guided sampler: the Python loop of ``diffusion`` around
    :func:`_guided_denoise_fn`. ``x_T [BG, L]`` and ``noise [S, BG, L]``
    as the unguided path takes them."""
    denoise = _guided_denoise_fn(w, input_emb, extra, cfg_scale)
    x_T = x_T.float()[:, None, :]
    noise = None if noise is None else noise.float()[:, :, None, :]
    kw = dict(x_T=x_T, generator=generator, return_trajectory=return_trajectory,
              guidance_fn=guidance_fn, guidance_scale=guidance_scale)
    if isinstance(diffusion, ElucidatedDiffusion):
        if sampler == "dpmpp":
            return diffusion.sample_dpmpp(denoise, x_T.shape[0],
                                          num_sample_steps=num_inference_steps, **kw)
        return diffusion.sample_churn(denoise, x_T.shape[0], num_sample_steps=num_inference_steps,
                                      noise=noise, **kw)
    return diffusion.sample(denoise, x_T.shape[0], num_inference_steps=num_inference_steps,
                            sampler=sampler, noise=noise, **kw)
