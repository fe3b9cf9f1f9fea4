"""The system under test: ``graspldm_tpu_torch``, built to a configuration
and loaded with the benchmark's weights. Imported lazily, so that the
benchmark's other modules load without the program."""

from __future__ import annotations

import dataclasses

import torch

OUT_KEYS = ("grasps", "grasp_tmrp", "confidence")


@dataclasses.dataclass
class Program:
    vae: object
    ddm: object
    diffusion: object
    weights: object  # the kernels' packed operands, packed once


def flagship_config(cfg: dict, control: bool = False):
    """The program's ``FlagshipConfig`` for ``cfg``; ``control`` computes
    the denoiser and decoder in bfloat16 (the lower-precision control)."""
    from graspldm_tpu_torch.flagship import FlagshipConfig

    return FlagshipConfig(
        pc_num_points=cfg["pc_num_points"], pc_latent_size=cfg["pc_latent_size"],
        pc_latent_channels=cfg["pc_latent_channels"], grasp_latent_size=cfg["grasp_latent_size"],
        grasp_representation_dims=cfg["grasp_representation_dims"],
        block_channels=tuple(cfg["block_channels"]), resnet_block_groups=cfg["resnet_block_groups"],
        dropout=cfg["dropout"], pc_scale_channels=cfg["pc_scale_channels"],
        pc_scale_voxel_resolution=cfg["pc_scale_voxel_resolution"],
        diffusion_timesteps=cfg["diffusion_timesteps"], beta_start=cfg["beta_start"],
        beta_end=cfg["beta_end"], beta_schedule=cfg["beta_schedule"],
        variance_type=cfg["variance_type"],
        denoiser_dtype="bfloat16" if control else None,
    )


def models(cfg: dict, state: dict, device, control: bool = False):
    """``(vae, ddm, diffusion)`` of the program with the state dicts
    ``state["vae"]`` and, where given, ``state["ddm"]`` loaded."""
    from graspldm_tpu_torch.flagship import build_flagship

    vae, ddm, diffusion = build_flagship(flagship_config(cfg, control), device=device)
    fixed = {"intermediate_feature_resolution": vae.intermediate_feature_resolution,
             "learned_sinusoidal_dim": ddm.learned_sinusoidal_dim}
    for k, v in fixed.items():
        if cfg[k] != v:
            raise ValueError(f"the program builds {k}={v}, the configuration states {cfg[k]}")
    vae.load_state_dict(state["vae"])
    if state.get("ddm") is not None:
        ddm.load_state_dict(state["ddm"])
    return vae, ddm, diffusion


def build(cfg: dict, state: dict, device, control: bool = False, ldm: bool = True) -> Program:
    """The program's models and its packed kernel weights (VAE-prior mode:
    no denoiser)."""
    from graspldm_tpu_torch.inference.pipeline import pack_generation_weights

    vae, ddm, diffusion = models(cfg, state, device, control)
    if not ldm:
        ddm = diffusion = None
    return Program(vae, ddm, diffusion, pack_generation_weights(vae, ddm, device=device))


def generate(prog: Program, pc: torch.Tensor, grasps: int, latents: torch.Tensor,
             steps: int, sampler: str, noise=None) -> dict:
    """One call as a caller makes it: normalise the clouds on the card,
    generate (``ldm_generate`` from ``x_T = latents`` and the sampler's
    ``noise``, or ``vae_generate`` from ``z_h = latents``) with the
    pre-packed weights."""
    from graspldm_tpu_torch.inference.pipeline import ldm_generate, vae_generate
    from graspldm_tpu_torch.utils.normalization import normalize_pc_and_grasps

    pc_n, _, meta = normalize_pc_and_grasps(pc, torch.zeros((pc.shape[0], 1, 6), device=pc.device))
    if prog.ddm is None:
        return vae_generate(prog.vae, pc_n, grasps, meta=meta, z_h=latents, weights=prog.weights)
    return ldm_generate(prog.vae, prog.ddm, prog.diffusion, pc_n, grasps,
                        num_inference_steps=steps, sampler=sampler, meta=meta, x_T=latents,
                        noise=noise, weights=prog.weights)
