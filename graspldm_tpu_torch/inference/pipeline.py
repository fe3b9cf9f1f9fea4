"""Generation pipelines: point clouds -> grasp poses (torch).

Counterpart of :mod:`graspldm_tpu.inference.pipeline`: encode the cloud
once (PVCNN, plain PyTorch), sample ``num_grasps`` latents (from N(0, I),
or by reverse diffusion), decode them, unnormalize, convert tmrp -> 4x4
transforms and sigmoid the success logit.

The denoiser and the decoder each take one of two routes, chosen per model
by ``denoiser_impl`` / ``decoder_impl`` as the JAX package chooses them
(``pipeline.py:_resolve_denoiser_impl``, ``_make_decode_fn``):

* ``"kernels"`` (the JAX package's ``"pallas"``): the hand-written kernels;
* ``"module"`` (its ``"flax"``): the plain ``nn.Module`` (the denoiser
  inside the Python-loop samplers, ``GraspCVAE.decode``);
* ``"auto"``: the kernels when the model qualifies, else the module.
  A model qualifies by the JAX package's rules: a denoiser with z4 / z16
  latents and random Fourier time features, a decoder at resolution 4 or
  16. This is a choice by model, never a fallback after a failed build or
  launch.

On the kernel route, reverse diffusion runs as in the JAX package:

* unguided (class / region conditioning included: its embedding is
  constant across steps and folds into the conditioning embedding): one
  sampler-kernel launch, ``ddim_sampler_kernel`` for DDIM/DDPM,
  ``dpmpp_sampler_kernel`` or ``churn_sampler_kernel`` for EDM; with
  ``return_trajectory`` one per-step kernel launch per step instead;
* guided (``cfg_scale``, ``guidance_scale`` or ``guidance_fn``): the
  Python-loop samplers, whose per-step guidance work (the CFG combine, the
  decoder VJP) runs between denoiser evaluations, each one ``full_kernel``
  launch (:func:`..models.stacked_cuda.stacked_denoiser_apply` with
  ``fuse_stages=True``), or with attention between launches
  (``stacked_cuda.XLA_ATTENTION``) at L > 4 one chain of hybrid kernels.

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
from ..models.stacked_cuda import PackedNet, _use_xla_attention, stacked_denoiser_apply
from ..models.stacked_denoiser import (
    DenoiserDims,
    compute_extra_emb,
    compute_input_emb,
    pack_math_weights,
)
from ..utils.normalization import NormalizationMeta, unnormalize_grasps
from ..utils.profiling import span
from ..utils.rotations import tmrp_to_H

__all__ = [
    "IMPLS",
    "GenerationWeights",
    "pack_generation_weights",
    "decode_and_postprocess",
    "trajectory_decode_indices",
    "vae_generate",
    "ldm_generate",
]


IMPLS = ("auto", "kernels", "module")


class GenerationWeights(NamedTuple):
    """Kernel operands of the decoder and the denoiser, packed once per
    model; None for a part that takes the plain-module route."""

    decoder: Optional[PackedNet]
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


_DENOISER_KERNELS = (
    "the kernel path supports GraspLatentDDM (z4/z16, random Fourier time embedding), "
    "ClassConditionedGraspLatentDDM with cls_cond, or RegionConditionedGraspLatentDDM "
    "with region_points"
)


def _check_condition(ddm, cond_kwargs: dict) -> None:
    """An unconditioned denoiser takes no condition, a class- or
    region-conditioned one exactly its own, on either route (the JAX
    package's ``cond_ok``; its module route fails in the module's apply)."""
    want = {None: set(), "class": {"cls_cond"}, "region": {"region_points"}}
    if set(cond_kwargs) != want[ddm.conditioning]:
        raise ValueError(f"{type(ddm).__name__} takes {sorted(want[ddm.conditioning])}, got "
                         f"{sorted(cond_kwargs)}; {_DENOISER_KERNELS}")


def _route(impl: str, qualifies: bool, what: str, refusal: str) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown {what}={impl!r}; expected one of {IMPLS}")
    if impl == "auto":
        return "kernels" if qualifies else "module"
    if impl == "kernels" and not qualifies:
        raise ValueError(f"{what}='kernels': {refusal}")
    return impl


def resolve_denoiser_impl(ddm, impl: str = "auto") -> str:
    """``"kernels"`` or ``"module"`` for ``ddm`` (the JAX package's
    ``_resolve_denoiser_impl`` with ``"pallas"`` / ``"flax"``): the kernels
    take z4 / z16 latents with random Fourier time features; ``"kernels"``
    for any other model raises ``ValueError``."""
    qualifies = ddm.latent_in_features in (4, 16) and ddm.random_fourier_features
    return _route(impl, qualifies, "denoiser_impl",
                  f"{_DENOISER_KERNELS}; got latent {ddm.latent_in_features}, random Fourier "
                  f"features {ddm.random_fourier_features}")


def resolve_decoder_impl(vae, impl: str = "auto") -> str:
    """``"kernels"`` or ``"module"`` for ``vae``'s decoder (the JAX package's
    ``_make_decode_fn``): the kernels take a GraspCVAE at intermediate
    feature resolution 4 or 16."""
    res = getattr(vae, "intermediate_feature_resolution", None)
    return _route(impl, res in (4, 16), "decoder_impl",
                  "the kernel path supports GraspCVAE with an intermediate feature "
                  f"resolution of 4 or 16; got {type(vae).__name__} / resolution {res!r}")


def _guided_denoise_fn(w: PackedNet, input_emb: torch.Tensor, extra: Optional[torch.Tensor],
                       cfg_scale: Optional[float]):
    """``denoise(x [BG, 1, L], t [BG], z) -> eps`` (float32) for the
    Python-loop samplers on the kernel route: one ``full_kernel`` launch
    per call, or the chain of hybrid kernels with attention between
    launches where ``stacked_cuda.XLA_ATTENTION`` holds at L > 4 (which
    refuses ``fuse_stages``, as the JAX package does).

    ``input_emb [BG, Ce, E]`` is hoisted out of the loop with the extra
    embedding folded in. With ``cfg_scale`` each call runs a doubled batch:
    rows ``[:BG]`` conditioned, rows ``[BG:]`` with the extra embedding
    zeroed (the null condition, ``cond_mask = 0``), combined as ``e_u + w
    (e_c - e_u)`` in float32 (``pipeline.py:_make_cfg_denoise_fn``)."""
    fuse = not _use_xla_attention(w.dims)
    if cfg_scale is None:
        ie = input_emb if extra is None else input_emb + extra[:, None, :]

        def denoise(x, t, z):
            return stacked_denoiser_apply(w, x, t, None, ie, fuse_stages=fuse).float()

        return denoise
    BG = input_emb.shape[0]
    ie2 = torch.cat([input_emb + extra[:, None, :], input_emb])

    def denoise(x, t, z):
        eps2 = stacked_denoiser_apply(w, torch.cat([x, x]), torch.cat([t, t]), None, ie2,
                                      fuse_stages=fuse).float()
        e_c, e_u = eps2[:BG], eps2[BG:]
        return e_u + cfg_scale * (e_c - e_u)

    return denoise


def _module_denoise_fn(ddm, z_pc_rep: torch.Tensor, cond_kwargs: dict,
                       cfg_scale: Optional[float]):
    """``denoise(x, t, z) -> eps`` (float32) on the plain-module route: the
    denoiser module itself (in its declared ``dtype``; a conditioned one in
    float32), as the JAX package's ``"flax"`` route applies it. With
    ``cfg_scale`` a doubled batch with ``cond_mask`` 1 then 0."""
    kw = {} if ddm.conditioning else {"dtype": ddm.dtype}
    if cfg_scale is None:
        def denoise(x, t, z):
            return ddm(x, t, z_pc_rep, **cond_kwargs, **kw).float()

        return denoise
    BG = z_pc_rep.shape[0]
    z2 = torch.cat([z_pc_rep, z_pc_rep])
    mask2 = torch.cat([torch.ones(BG, device=z2.device), torch.zeros(BG, device=z2.device)])
    ck2 = {k: torch.cat([v, v]) for k, v in cond_kwargs.items()}

    def denoise(x, t, z):
        eps2 = ddm(torch.cat([x, x]), torch.cat([t, t]), z2, cond_mask=mask2, **ck2).float()
        e_c, e_u = eps2[:BG], eps2[BG:]
        return e_u + cfg_scale * (e_c - e_u)

    return denoise


@torch.no_grad()
def pack_generation_weights(vae, ddm=None, device=None, denoiser_impl: str = "auto",
                            decoder_impl: str = "auto") -> GenerationWeights:
    """Pack what the kernel route uses: the decoder (and denoiser) at their
    declared compute dtypes (a class- or region-conditioned denoiser
    declares none: float32); a part on the plain-module route
    (:func:`resolve_denoiser_impl`, :func:`resolve_decoder_impl`) is None.
    No ``device`` named: the device of ``vae``'s parameters."""
    if device is None:
        device = next(vae.parameters()).device
    dec = None
    if resolve_decoder_impl(vae, decoder_impl) == "kernels":
        dec = pack_decoder_weights(
            vae, decoder_dims_for(vae), _kernel_dtype(vae.decoder_dtype), device
        )
    den = None
    if ddm is not None and resolve_denoiser_impl(ddm, denoiser_impl) == "kernels":
        dims = _denoiser_dims(ddm)
        den = PackedNet(pack_math_weights(ddm, dims), dims, _kernel_dtype(ddm.dtype), device)
    return GenerationWeights(dec, den)


def _weights_for(weights: Optional[GenerationWeights], vae, ddm, device, den_route: str,
                 dec_route: str) -> GenerationWeights:
    """The kernel operands of the parts on the kernel route (None for the
    others): ``weights``, packed by the caller and checked against the
    routes, or packed here."""
    if weights is None:
        return pack_generation_weights(vae, ddm, device, den_route, dec_route)
    for part, route in (("decoder", dec_route), ("denoiser", den_route)):
        if route == "kernels" and getattr(weights, part) is None:
            raise ValueError(f"the {part} takes the kernel route but weights.{part} is None")
    return GenerationWeights(weights.decoder if dec_route == "kernels" else None,
                             weights.denoiser if den_route == "kernels" else None)


def decode_and_postprocess(
    weights: GenerationWeights, z_h: torch.Tensor, z_pc_rep: torch.Tensor,
    num_grasps: int, meta: Optional[NormalizationMeta], vae=None,
) -> Dict[str, torch.Tensor]:
    """Decode latents to world-frame grasps: ``grasps [B, G, 4, 4]``,
    ``grasp_tmrp [B, G, 6]``, ``confidence [B, G]``[, ``qualities``].
    Through the kernels when ``weights.decoder`` is packed, else through
    ``vae.decode``. Recorded as the ``graspldm.decode`` span."""
    with span("decode"):
        if weights.decoder is not None:
            out = decoder_fast_apply(weights.decoder, z_h, z_pc_rep)
        elif vae is None:
            raise ValueError("the plain-module decoder route needs the vae")
        else:
            out = vae.decode(z_h, z_pc_rep)
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
    weights: Optional[GenerationWeights] = None, decoder_impl: str = "auto",
) -> Dict[str, torch.Tensor]:
    """VAE-mode generation: latents from the N(0, I) prior. Runs on the
    device of ``pc`` and of the models (the caller puts them there).

    Args:
        pc: ``[B, N, 3]`` normalized clouds. ``z_h [B*G, latent]`` overrides
            the prior draw (tests inject JAX's).
        decoder_impl: ``"auto"``, ``"kernels"`` or ``"module"`` (the JAX
            package's ``"auto"``, ``"pallas"``, ``"flax"``): see
            :func:`resolve_decoder_impl`.
    """
    with span("vae_generate"):
        dec_route = resolve_decoder_impl(vae, decoder_impl)
        weights = _weights_for(weights, vae, None, pc.device, "module", dec_route)
        with span("encode"):
            z_pc = vae.encode_pc(pc)
        z_pc_rep = z_pc.repeat_interleave(num_grasps, dim=0)
        if z_h is None:
            z_h = torch.randn((pc.shape[0] * num_grasps, vae.grasp_latent_size),
                              generator=generator, device=pc.device)
        return decode_and_postprocess(weights, z_h, z_pc_rep, num_grasps, meta, vae)


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
    denoiser_impl: str = "auto", decoder_impl: str = "auto",
) -> Dict[str, torch.Tensor]:
    """LDM-mode generation: reverse diffusion in the grasp latent space.
    Runs on the device of ``pc`` and of the models (the caller puts them
    there).

    ``denoiser_impl`` / ``decoder_impl`` pick each part's route:
    ``"kernels"`` (the JAX package's ``"pallas"``), ``"module"`` (its
    ``"flax"``) or ``"auto"`` (the kernels when the model qualifies, see
    :func:`resolve_denoiser_impl` and :func:`resolve_decoder_impl`).

    On the kernel route, unguided, without ``return_trajectory`` the whole
    sampler runs in one kernel launch. With a
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

    Any of the three, and the plain-module denoiser route, runs the
    Python-loop sampler (DDIM/DDPM: one denoiser evaluation per step;
    DPM++: N; churn: 2N - 1); on the kernel route each evaluation is one
    ``full_kernel`` launch. The draws from ``generator`` are the same on
    every route.
    """
    with span("ldm_generate"):
        edm = isinstance(diffusion, ElucidatedDiffusion)
        if not edm and sampler not in ("ddim", "ddpm"):
            raise ValueError(f"sampler {sampler!r} needs an ElucidatedDiffusion; "
                             "GaussianDiffusion1D takes 'ddim' or 'ddpm'")
        cond_kwargs = {k: torch.as_tensor(v, device=pc.device)
                       for k, v in (("cls_cond", cls_cond), ("region_points", region_points))
                       if v is not None}
        _check_condition(ddm, cond_kwargs)
        den_route = resolve_denoiser_impl(ddm, denoiser_impl)
        dec_route = resolve_decoder_impl(vae, decoder_impl)
        if cfg_scale is not None and not cond_kwargs:
            raise ValueError("cfg_scale requires a conditioned denoiser "
                             "(cls_cond or region_points)")
        weights = _weights_for(weights, vae, ddm, pc.device, den_route, dec_route)
        with span("encode"):
            z_pc = vae.encode_pc(pc)
        z_pc_rep = z_pc.repeat_interleave(num_grasps, dim=0)
        BG = z_pc_rep.shape[0]
        if x_T is None:
            x_T = torch.randn((BG, ddm.latent_in_features), generator=generator, device=pc.device)
            if edm:
                x_T = diffusion.sample_schedule(num_inference_steps)[0].item() * x_T
        if guidance_fn is None and guidance_scale is not None:
            guidance_fn = make_success_guidance(vae, z_pc_rep)
        guided = guidance_fn is not None or cfg_scale is not None
        if den_route == "module":
            denoise = _module_denoise_fn(ddm, z_pc_rep, cond_kwargs, cfg_scale)
        else:
            input_emb = compute_input_emb(weights.denoiser.aux, z_pc_rep)
            extra = compute_extra_emb(weights.denoiser.aux, **cond_kwargs)
            denoise = _guided_denoise_fn(weights.denoiser, input_emb, extra, cfg_scale)
        with span("sample"):
            if den_route == "module" or guided:
                res = _loop_sample(denoise, diffusion, x_T, noise, generator, num_inference_steps,
                                   sampler, return_trajectory, guidance_fn,
                                   1.0 if guidance_scale is None else float(guidance_scale))
            else:
                if extra is not None:
                    input_emb = input_emb + extra[:, None, :]
                res = _fused_sample(weights.denoiser, diffusion, input_emb, x_T, noise, generator,
                                    num_inference_steps, sampler, return_trajectory)
        x0, traj = res if return_trajectory else (res, None)
        result = decode_and_postprocess(weights, x0[:, 0, :], z_pc_rep, num_grasps, meta, vae)
        if return_trajectory:
            result["latent_trajectory"] = traj
            result["all_diffusion_grasps"] = torch.stack([
                decode_and_postprocess(weights, traj[i, :, 0, :], z_pc_rep, num_grasps, meta,
                                       vae)["grasps"]
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


def _loop_sample(denoise, diffusion, x_T, noise, generator, num_inference_steps: int,
                 sampler: str, return_trajectory: bool, guidance_fn, guidance_scale: float):
    """The Python loop of ``diffusion`` around ``denoise`` (the guided
    samplers, and every sampler on the plain-module route). ``x_T [BG, L]``
    and ``noise [S, BG, L]`` as the whole-trajectory kernels take them."""
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
