"""Whole-trajectory DDIM/DDPM sampler kernel.

Counterpart of :mod:`graspldm_tpu.models.pallas_sampler`'s whole-scan
branch. ``ddim_sampler_kernel`` replaces ``pallas_sampler.py:_mega_kernel``:
one launch runs every reverse-diffusion step for a block of rows, with the
fp32 carry, the conditioning embedding and all activations resident in
shared memory. Its step body calls the same device functions as the stage
kernels (``csrc/resnet1d_blocks.cuh``). Rows need not fill the last block:
the kernel masks the ragged edge itself (the JAX sampler pads rows to the
block size instead).

The per-step tables stay in plain PyTorch, outside the kernel: the time
embedding rows ``compute_time_emb(ts)`` tiled over the Ce conditioning
channels, and the scheduler coefficients (:func:`_step_coeffs`). DDPM takes
its per-step noise as an explicit ``[S, BG, L]`` tensor, so tests can feed
JAX's draws.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ..diffusion.schedules import DiffusionSchedule
from .stacked_cuda import (
    DTYPE_CODE,
    KernelCounter,
    PackedNet,
    _check,
    _final_core,
    _on_cuda,
    _ptr,
    _raise_on,
    _rnd,
    _stage_core,
    init_conv,
)
from .stacked_denoiser import compute_time_emb

__all__ = ["SAMPLER_KERNEL", "fused_sample", "sampler_tables", "sampler_plain", "sampler_apply"]

SAMPLER_KERNEL = KernelCounter("ddim_sampler_kernel")


def _step_coeffs(schedule: DiffusionSchedule, ts: torch.Tensor, prev: torch.Tensor,
                 sampler: str, variance_type: str) -> torch.Tensor:
    """``[S, 8]`` float32 scheduler scalars per step.

    ddim (eta=0): ``x0 = a*x - b*eps``; ``x = d*x + e*clip(x0)`` with
    ``a = 1/sqrt(acp_t)``, ``b = sqrt(1-acp_t)*a``,
    ``d = sqrt(1-acp_prev)/sqrt(1-acp_t)``, ``e = sqrt(acp_prev) - d*sqrt(acp_t)``.
    ddpm: ``x = c0*clip(x0) + c1*x + sigma*noise``.
    """
    acp = schedule.alphas_cumprod
    acp_t = acp[ts]
    acp_prev = torch.where(prev >= 0, acp[prev.clamp(min=0)], torch.ones_like(acp_t))
    a = 1.0 / torch.sqrt(acp_t)
    b = torch.sqrt(1.0 - acp_t) * a
    if sampler == "ddim":
        d = torch.sqrt(1.0 - acp_prev) / torch.sqrt(1.0 - acp_t)
        e = torch.sqrt(acp_prev) - d * torch.sqrt(acp_t)
        rows = [a, b, d, e]
    else:
        alpha = acp_t / acp_prev
        beta = 1.0 - alpha
        c0 = torch.sqrt(acp_prev) * beta / (1.0 - acp_t)
        c1 = torch.sqrt(alpha) * (1.0 - acp_prev) / (1.0 - acp_t)
        if variance_type in ("fixed_small", "fixed_small_log"):
            var = torch.clamp((1.0 - acp_prev) / (1.0 - acp_t) * beta, min=1e-20)
        else:
            var = beta
        sigma = torch.where(prev >= 0, torch.sqrt(var.clamp(min=0.0)), torch.zeros_like(var))
        rows = [a, b, c0, c1, sigma]
    rows += [torch.zeros_like(a)] * (8 - len(rows))
    return torch.stack(rows, dim=-1).float()


def sampler_plain(w: PackedNet, x_T, embin, trows, coefs, noise, clip: bool,
                  clip_range: float) -> torch.Tensor:
    """Plain version of ``ddim_sampler_kernel``; same rounding points."""
    x = x_T.float().clone()
    BG, Ce = x.shape[0], w.dims.cond_channels
    for s in range(coefs.shape[0]):
        emb = _rnd(F.silu(embin + trows[s]), w.dtype)
        esum = emb.reshape(BG, Ce, -1).sum(1)
        h = init_conv(w, x)
        for i in range(len(w.dims.block_channels)):
            h = _stage_core(w, i, h, esum)
        eps = _final_core(w, h, esum)
        c = coefs[s]
        x0 = c[0] * x - c[1] * eps
        if clip:
            x0 = x0.clamp(-clip_range, clip_range)
        if noise is None:
            x = c[2] * x + c[3] * x0
        else:
            x = c[2] * x0 + c[3] * x + c[4] * noise[s]
    return x


def sampler_apply(w: PackedNet, x_T, embin, trows, coefs, noise=None, clip=True,
                  clip_range=1.0) -> torch.Tensor:
    """All S steps for ``x_T [BG, L]`` (fp32) -> ``x_0 [BG, L]`` (fp32).

    ``embin [BG, Ce*E]`` is the pre-silu conditioning embedding, ``trows
    [S, Ce*E]`` the per-step time rows, ``coefs [S, 8]`` from
    :func:`_step_coeffs`, ``noise [S, BG, L]`` for DDPM (None for DDIM).
    """
    if not _on_cuda(x_T):
        return sampler_plain(w, x_T, embin, trows, coefs, noise, clip, clip_range)
    from ..cuda_build import load_library

    d = w.dims
    BG, L = x_T.shape
    S, CeE = coefs.shape[0], d.cond_channels * d.emb_dim
    f32 = torch.float32
    _check("x_T", x_T, (BG, L), f32, w.device)
    _check("embin", embin, (BG, CeE), f32, w.device)
    _check("trows", trows, (S, CeE), f32, w.device)
    _check("coefs", coefs, (S, 8), f32, w.device)
    if noise is not None:
        _check("noise", noise, (S, BG, L), f32, w.device)
    cmax = max((w.w["init_w"].shape[1],) + tuple(d.cins) + tuple(d.block_channels))
    out = torch.empty((BG, L), dtype=f32, device=x_T.device)
    rc = load_library().gl_ddim_sample(
        DTYPE_CODE[w.dtype], _ptr(x_T), _ptr(embin), _ptr(trows), _ptr(coefs),
        _ptr(noise), _ptr(w.flat), _ptr(w.layout), _ptr(out), BG, S, L, d.emb_dim,
        d.cond_channels, d.groups, cmax, int(bool(clip)), float(clip_range),
        ctypes.c_void_p(torch.cuda.current_stream(x_T.device).cuda_stream),
    )
    _raise_on(rc, "ddim_sampler_kernel")
    SAMPLER_KERNEL.launches += 1
    return out


def sampler_tables(w: PackedNet, schedule: DiffusionSchedule, input_emb: torch.Tensor,
                   num_inference_steps: int, sampler: str, variance_type: str):
    """The kernel's float32 operands besides ``x_T`` and the noise:
    ``embin [BG, Ce*E]``, ``trows [S, Ce*E]`` and ``coefs [S, 8]``."""
    device = input_emb.device
    ts = schedule.timestep_grid(num_inference_steps)
    prev = ts - schedule.num_train_timesteps // num_inference_steps
    coefs = _step_coeffs(schedule, ts, prev, sampler, variance_type).to(device)
    Ce = input_emb.shape[1]
    trows = compute_time_emb(w.aux, ts.to(device)).repeat(1, Ce).contiguous()
    embin = input_emb.reshape(input_emb.shape[0], -1).float().contiguous()
    return embin, trows, coefs


def fused_sample(
    w: PackedNet,
    schedule: DiffusionSchedule,
    input_emb: torch.Tensor,
    x_T: torch.Tensor,
    num_inference_steps: Optional[int] = None,
    sampler: str = "ddim",
    variance_type: str = "fixed_large",
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Reverse diffusion in one kernel launch.

    Args:
        input_emb: ``[BG, Ce, emb]`` hoisted conditioning embedding
            (``compute_input_emb``), the pre-silu FiLM input.
        x_T: ``[BG, L]`` starting latents (float32).
        noise: ``[len(grid), BG, L]`` DDPM noise, one draw per step of
            ``schedule.timestep_grid``; drawn from ``generator`` if None.
    Returns:
        ``x_0 [BG, 1, L]`` float32.
    """
    if sampler not in ("ddim", "ddpm"):
        raise ValueError(f"Unknown sampler: {sampler}")
    device = x_T.device
    S = num_inference_steps or schedule.num_train_timesteps
    embin, trows, coefs = sampler_tables(w, schedule, input_emb, S, sampler, variance_type)
    if sampler == "ddpm" and noise is None:
        noise = torch.randn((coefs.shape[0],) + tuple(x_T.shape), generator=generator,
                            device=device)
    x0 = sampler_apply(
        w, x_T.float().contiguous(), embin, trows, coefs,
        noise.float().contiguous() if sampler == "ddpm" else None,
        schedule.clip_sample, schedule.clip_sample_range,
    )
    return x0[:, None, :]
