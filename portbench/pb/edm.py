"""The system under test in GraspLDM's EDM mode (``elucidated_ddm``): the
program's flagship built with ``elucidated=True``, so that ``ldm_generate``
holds an ``ElucidatedDiffusion`` and ``sampler="dpmpp"`` runs
DPM-Solver++(2M). Imported lazily, as :mod:`pb.program` is; calls go
through :func:`pb.program.generate`."""

from __future__ import annotations

import dataclasses

from . import program

# the configuration's EDM numbers, each held against the program's
EDM_KEYS = ("sigma_min", "sigma_max", "sigma_data", "rho")


def build(cfg: dict, state: dict, device, steps: int, control: bool = False) -> program.Program:
    """The program's EDM models, sampling in ``steps`` steps, with the state
    dicts ``state["vae"]`` and ``state["ddm"]`` loaded, and its packed kernel
    weights. Raises where the program builds another number than the
    configuration states."""
    from graspldm_tpu_torch.diffusion import ElucidatedDiffusion
    from graspldm_tpu_torch.flagship import build_flagship
    from graspldm_tpu_torch.inference.pipeline import pack_generation_weights

    fc = dataclasses.replace(program.flagship_config(cfg, control), elucidated=True,
                             edm_num_sample_steps=steps)
    vae, ddm, diffusion = build_flagship(fc, device=device)
    if not isinstance(diffusion, ElucidatedDiffusion):
        raise ValueError(f"the program builds {type(diffusion).__name__}, not EDM")
    built = {"intermediate_feature_resolution": vae.intermediate_feature_resolution,
             "learned_sinusoidal_dim": ddm.learned_sinusoidal_dim,
             **{k: getattr(diffusion, k) for k in EDM_KEYS}}
    for k, v in built.items():
        if cfg[k] != v:
            raise ValueError(f"the program builds {k}={v}, the configuration states {cfg[k]}")
    vae.load_state_dict(state["vae"])
    ddm.load_state_dict(state["ddm"])
    return program.Program(vae, ddm, diffusion, pack_generation_weights(vae, ddm, device=device))
