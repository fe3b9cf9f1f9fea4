"""Sampler kernels: DDIM/DDPM and the two EDM samplers.

Counterpart of :mod:`graspldm_tpu.models.pallas_sampler`. Without a
trajectory, each sampler runs as one whole-trajectory kernel (the JAX
package's whole-scan branch): every step for a block of rows in one launch,
with the fp32 carry, the conditioning embedding and all activations
resident in shared memory:

* ``ddim_sampler_kernel`` replaces ``pallas_sampler.py:_mega_kernel``
  (DDIM / DDPM);
* ``dpmpp_sampler_kernel`` replaces ``pallas_sampler.py:_mega_dpmpp_kernel``
  (EDM DPM-Solver++(2M), ``x`` and the previous denoised estimate carried);
* ``churn_sampler_kernel`` replaces ``pallas_sampler.py:_mega_churn_kernel``
  (EDM stochastic churn with the Heun correction, two network evaluations
  per step).

With ``return_trajectory`` (the JAX package's per-step scan), the host
loops over the steps and launches one per-step kernel each
(``csrc/step_samplers.cu``), which writes its state straight into the
preallocated trajectory:

* ``ddim_step_kernel`` replaces ``_full_step_kernel`` and the chain
  ``_stage0_kernel`` -> ``_mid_stage_kernel`` -> ``_final_step_kernel``;
* ``dpmpp_step_kernel`` replaces ``_full_dpmpp_kernel`` and the chain
  ``_stage0_dpmpp_kernel`` -> ``_mid_stage_kernel`` -> ``_final_dpmpp_kernel``;
* ``churn_step_kernel`` replaces ``_full_churn_kernel`` and the two chains
  ending in ``_final_churn_a_kernel`` and ``_final_churn_b_kernel``.

All six share one step body (``net_step`` in ``csrc/sampler_body.cuh``),
built from the same device functions as the stage kernels
(``csrc/resnet1d_blocks.cuh``). Rows need not fill the last block: the
kernels mask the ragged edge themselves (the JAX sampler pads rows to the
block size instead).

The per-step tables stay in plain PyTorch, outside the kernels: the time
embedding rows ``compute_time_emb`` tiled over the Ce conditioning
channels, and the per-step coefficient rows. Each sampler builds them under
``utils.profiling.SAMPLER_TABLES`` (the span ``graspldm.sampler_tables``).
The samplers that draw noise (DDPM, churn) take it as an explicit
``[S, BG, L]`` tensor, so tests can feed JAX's draws.

Beside each kernel is its plain PyTorch version with the same rounding
points: one step each (``ddim_step_plain``, ``dpmpp_step_plain``,
``churn_step_plain``), and the whole trajectories (``sampler_plain``,
``dpmpp_sampler_plain``, ``churn_sampler_plain``) as loops over them. A
wrapper runs the plain version for CPU tensors and launches the kernel (or
raises) for CUDA tensors.

With attention between launches (``stacked_cuda.XLA_ATTENTION``) at
L > 4 the samplers and every sampler wrapper raise ``ValueError``, as
``pallas_sampler.py:fused_sample`` and its EDM siblings do: these kernels
run the attention inside the network.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..cuda_build import KernelCounter, check_operand, on_cuda, ptr
from ..diffusion.elucidated import ElucidatedDiffusion
from ..diffusion.schedules import DiffusionSchedule
from ..utils.profiling import SAMPLER_TABLES
from .stacked_cuda import (
    DTYPE_CODE,
    PackedNet,
    _final_core,
    _rnd,
    _stage_core,
    _use_xla_attention,
    init_conv,
)
from .stacked_denoiser import compute_time_emb

__all__ = [
    "SAMPLER_KERNEL", "fused_sample", "sampler_tables", "sampler_plain", "sampler_apply",
    "DDIM_STEP_KERNEL", "ddim_step_plain", "ddim_step_apply",
    "DPMPP_KERNEL", "fused_sample_dpmpp", "dpmpp_tables", "dpmpp_sampler_plain",
    "dpmpp_sampler_apply", "DPMPP_STEP_KERNEL", "dpmpp_step_plain", "dpmpp_step_apply",
    "CHURN_KERNEL", "fused_sample_churn", "churn_tables", "churn_sampler_plain",
    "churn_sampler_apply", "CHURN_STEP_KERNEL", "churn_step_plain", "churn_step_apply",
]

SAMPLER_KERNEL = KernelCounter("ddim_sampler_kernel", "gl_ddim_sample")
DPMPP_KERNEL = KernelCounter("dpmpp_sampler_kernel", "gl_dpmpp_sample")
CHURN_KERNEL = KernelCounter("churn_sampler_kernel", "gl_churn_sample")
DDIM_STEP_KERNEL = KernelCounter("ddim_step_kernel", "gl_ddim_step")
DPMPP_STEP_KERNEL = KernelCounter("dpmpp_step_kernel", "gl_dpmpp_step")
CHURN_STEP_KERNEL = KernelCounter("churn_step_kernel", "gl_churn_step")


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


def _net_plain(w: PackedNet, x_in: torch.Tensor, embin, trow) -> torch.Tensor:
    """Plain version of ``net_step``: the whole network on ``x_in [BG, L]``
    (rounded to the compute dtype by the init conv) with the FiLM input
    ``silu(embin + trow)`` -> float32 values ``[BG, L]`` rounded to it."""
    emb = _rnd(F.silu(embin + trow), w.dtype)
    esum = emb.reshape(x_in.shape[0], w.dims.cond_channels, -1).sum(1)
    h = init_conv(w, x_in)
    for i in range(len(w.dims.block_channels)):
        h = _stage_core(w, i, h, esum)
    return _final_core(w, h, esum)


def ddim_step_plain(w: PackedNet, x, embin, trow, coef, noise_s, clip: bool,
                    clip_range: float) -> torch.Tensor:
    """Plain version of ``ddim_step_kernel``: one DDIM (``noise_s`` None) or
    DDPM step of ``x [BG, L]`` (fp32) with time row ``trow [Ce*E]`` and
    coefficient row ``coef [8]``; same rounding points."""
    eps = _net_plain(w, x, embin, trow)
    x0 = coef[0] * x - coef[1] * eps
    if clip:
        x0 = x0.clamp(-clip_range, clip_range)
    if noise_s is None:
        return coef[2] * x + coef[3] * x0
    return coef[2] * x0 + coef[3] * x + coef[4] * noise_s


def sampler_plain(w: PackedNet, x_T, embin, trows, coefs, noise, clip: bool,
                  clip_range: float) -> torch.Tensor:
    """Plain version of ``ddim_sampler_kernel``: every step of
    :func:`ddim_step_plain`."""
    x = x_T.float().clone()
    for s in range(coefs.shape[0]):
        x = ddim_step_plain(w, x, embin, trows[s], coefs[s],
                            None if noise is None else noise[s], clip, clip_range)
    return x


def _in_kernel_attention(w: PackedNet, name: str) -> None:
    """The refusal of ``pallas_sampler.py:768`` / ``:976`` / ``:1165``."""
    if _use_xla_attention(w.dims):
        raise ValueError(f"{name} requires in-kernel attention")


def _check_tables(w: PackedNet, x_T, embin, S, **rows) -> None:
    """Operand checks shared by the sampler wrappers: ``x_T [BG, L]``,
    ``embin [BG, Ce*E]``, each time-row table ``[S, Ce*E]`` and each
    coefficient table ``[S, 8]``, all float32 on the weights' device."""
    d = w.dims
    BG = x_T.shape[0]
    CeE, f32 = d.cond_channels * d.emb_dim, torch.float32
    check_operand("x_T", x_T, (BG, d.seq_len), f32, w.device)
    check_operand("embin", embin, (BG, CeE), f32, w.device)
    for name, t in rows.items():
        check_operand(name, t, (S, 8 if name.startswith("coef") else CeE), f32, w.device)


def _check_step(w: PackedNet, x, embin, states: dict, **rows) -> None:
    """Operand checks of a per-step wrapper: ``x [BG, L]``, ``embin``, the
    other ``[BG, L]`` inputs in ``states`` (name -> tensor or None), each
    time row ``[Ce*E]`` and each coefficient row ``[8]`` of one step, all
    float32 on the weights' device."""
    _check_tables(w, x, embin, 1, **{k: v[None] for k, v in rows.items()})
    for name, t in states.items():
        if t is not None:
            check_operand(name, t, tuple(x.shape), torch.float32, w.device)


def _out(out: Optional[torch.Tensor], like: torch.Tensor, check: bool) -> torch.Tensor:
    """The step's output buffer: ``out`` (a preallocated ``[BG, L]`` fp32
    slot, e.g. a row of the trajectory) or a new one."""
    if out is None:
        return torch.empty_like(like, dtype=torch.float32)
    if check:
        check_operand("out", out, tuple(like.shape), torch.float32, like.device)
    return out


def sampler_apply(w: PackedNet, x_T, embin, trows, coefs, noise=None, clip=True,
                  clip_range=1.0) -> torch.Tensor:
    """All S steps for ``x_T [BG, L]`` (fp32) -> ``x_0 [BG, L]`` (fp32).

    ``embin [BG, Ce*E]`` is the pre-silu conditioning embedding, ``trows
    [S, Ce*E]`` the per-step time rows, ``coefs [S, 8]`` from
    :func:`_step_coeffs`, ``noise [S, BG, L]`` for DDPM (None for DDIM).
    """
    _in_kernel_attention(w, "sampler_apply")
    if not on_cuda(x_T):
        return sampler_plain(w, x_T, embin, trows, coefs, noise, clip, clip_range)
    d = w.dims
    BG, L = x_T.shape
    S, f32 = coefs.shape[0], torch.float32
    _check_tables(w, x_T, embin, S, trows=trows, coefs=coefs)
    if noise is not None:
        check_operand("noise", noise, (S, BG, L), f32, w.device)
    out = torch.empty((BG, L), dtype=f32, device=x_T.device)
    SAMPLER_KERNEL(x_T, DTYPE_CODE[w.dtype], ptr(x_T), ptr(embin), ptr(trows), ptr(coefs),
                   ptr(noise), ptr(w.flat), ptr(w.layout), ptr(out), BG, S, L, d.emb_dim,
                   d.cond_channels, d.groups, w.cmax, int(bool(clip)), float(clip_range))
    return out


def ddim_step_apply(w: PackedNet, x, embin, trow, coef, noise_s=None, clip=True,
                    clip_range=1.0, out=None, check=True) -> torch.Tensor:
    """One DDIM / DDPM step ``x [BG, L]`` (fp32) -> ``[BG, L]`` (fp32),
    written into ``out`` when given.

    ``trow [Ce*E]`` and ``coef [8]`` are row s of :func:`sampler_tables`'
    ``trows`` and ``coefs``, ``noise_s [BG, L]`` step s's DDPM noise (None
    for DDIM). ``check=False`` skips the operand checks: a trajectory
    checks its tables once, not at every step.
    """
    _in_kernel_attention(w, "ddim_step_apply")
    if not on_cuda(x):
        res = ddim_step_plain(w, x, embin, trow, coef, noise_s, clip, clip_range)
        return res if out is None else out.copy_(res)
    if check:
        _check_step(w, x, embin, dict(noise_s=noise_s), trow=trow, coef=coef)
    out = _out(out, x, check)
    d = w.dims
    BG, L = x.shape
    DDIM_STEP_KERNEL(x, DTYPE_CODE[w.dtype], ptr(x), ptr(embin), ptr(trow), ptr(coef),
                     ptr(noise_s), ptr(w.flat), ptr(w.layout), ptr(out), BG, L, d.emb_dim,
                     d.cond_channels, d.groups, w.cmax, int(bool(clip)), float(clip_range))
    return out


def _trajectory(x_T: torch.Tensor, n: int) -> torch.Tensor:
    """An empty ``[n, BG, L]`` float32 trajectory beside ``x_T``."""
    return torch.empty((n,) + tuple(x_T.shape), dtype=torch.float32, device=x_T.device)


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
    return_trajectory: bool = False,
):
    """Reverse diffusion: one whole-trajectory kernel launch, or with
    ``return_trajectory`` one ``ddim_step_kernel`` launch per step of
    ``schedule.timestep_grid``.

    Args:
        input_emb: ``[BG, Ce, emb]`` hoisted conditioning embedding
            (``compute_input_emb``), the pre-silu FiLM input.
        x_T: ``[BG, L]`` starting latents (float32).
        noise: ``[len(grid), BG, L]`` DDPM noise, one draw per step of
            ``schedule.timestep_grid``; drawn from ``generator`` if None.
    Returns:
        ``x_0 [BG, 1, L]`` float32; with ``return_trajectory`` the pair
        ``(x_0, trajectory [len(grid) + 1, BG, 1, L])``, x_T first, as
        ``pallas_sampler.py:fused_sample`` returns them.
    """
    _in_kernel_attention(w, "fused_sample")
    if sampler not in ("ddim", "ddpm"):
        raise ValueError(f"Unknown sampler: {sampler}")
    device = x_T.device
    S = num_inference_steps or schedule.num_train_timesteps
    with SAMPLER_TABLES.timed():
        embin, trows, coefs = sampler_tables(w, schedule, input_emb, S, sampler, variance_type)
    if sampler == "ddpm" and noise is None:
        noise = torch.randn((coefs.shape[0],) + tuple(x_T.shape), generator=generator,
                            device=device)
    x_T = x_T.float().contiguous()
    noise = noise.float().contiguous() if sampler == "ddpm" else None
    clip = (schedule.clip_sample, schedule.clip_sample_range)
    if not return_trajectory:
        return sampler_apply(w, x_T, embin, trows, coefs, noise, *clip)[:, None, :]
    n = coefs.shape[0]
    if on_cuda(x_T):
        _check_tables(w, x_T, embin, n, trows=trows, coefs=coefs)
        if noise is not None:
            check_operand("noise", noise, (n,) + tuple(x_T.shape), torch.float32, w.device)
    traj = _trajectory(x_T, n + 1)
    traj[0] = x_T
    for s in range(n):
        ddim_step_apply(w, traj[s], embin, trows[s], coefs[s],
                        None if noise is None else noise[s], *clip, out=traj[s + 1],
                        check=False)
    return traj[-1][:, None, :], traj[:, :, None, :]


# ---------------------------------------------------------------------------
# EDM: DPM-Solver++(2M)
# ---------------------------------------------------------------------------


def dpmpp_tables(w: PackedNet, ed: ElucidatedDiffusion, input_emb: torch.Tensor, N: int):
    """``dpmpp_sampler_kernel``'s float32 operands besides ``x_T``:
    ``embin [BG, Ce*E]``, ``trows [N, Ce*E]`` (the time embedding at
    ``c_noise(sigma_i)``) and ``coefs [N, 8]`` = ``[c_in, c_skip, c_out, g1,
    g2, ratio, em1, 0]`` at ``sigma_i``, built as
    ``pallas_sampler.py:fused_sample_dpmpp`` builds them."""
    device = input_emb.device
    sigmas = ed.sample_schedule(N)
    sig_i, sig_next = sigmas[:-1], sigmas[1:]
    sig_prev = torch.cat([sig_i[:1], sig_i[:-1]])

    def t_fn(s):
        return -torch.log(torch.clamp(s, min=1e-20))

    def nonzero(v):
        return torch.where(v == 0, torch.full_like(v, 1e-20), v)

    t_i, t_next = t_fn(sig_i), t_fn(sig_next)
    h = t_next - t_i
    r = (t_i - t_fn(sig_prev)) / nonzero(h)
    gamma = -1.0 / (2.0 * nonzero(r))
    first = (torch.arange(N) == 0) | (sig_next == 0.0)
    g1 = torch.where(first, torch.ones_like(gamma), 1.0 - gamma)
    g2 = torch.where(first, torch.zeros_like(gamma), gamma)
    ratio = torch.clamp(sig_next, min=1e-20) / torch.clamp(sig_i, min=1e-20)
    coefs = torch.stack([ed.c_in(sig_i), ed.c_skip(sig_i), ed.c_out(sig_i), g1, g2, ratio,
                         torch.expm1(-h), torch.zeros_like(h)], dim=-1).float().to(device)
    Ce = input_emb.shape[1]
    trows = compute_time_emb(w.aux, ed.c_noise(sig_i).to(device)).repeat(1, Ce).contiguous()
    embin = input_emb.reshape(input_emb.shape[0], -1).float().contiguous()
    return embin, trows, coefs


def dpmpp_step_plain(w: PackedNet, x, old, embin, trow, coef, clamp: bool):
    """Plain version of ``dpmpp_step_kernel``: one DPM-Solver++(2M) step of
    ``x [BG, L]`` (fp32) with the previous denoised estimate ``old`` ->
    ``(x_new, denoised)``; same rounding points (the network input ``c_in *
    x`` is rounded to the compute dtype)."""
    net = _net_plain(w, coef[0] * x, embin, trow)
    den = coef[1] * x + coef[2] * net
    if clamp:
        den = den.clamp(-1.0, 1.0)
    return coef[5] * x - coef[6] * (coef[3] * den + coef[4] * old), den


def dpmpp_sampler_plain(w: PackedNet, x_T, embin, trows, coefs, clamp: bool) -> torch.Tensor:
    """Plain version of ``dpmpp_sampler_kernel``: every step of
    :func:`dpmpp_step_plain`, ``old`` zeros at the first."""
    x = x_T.float().clone()
    old = torch.zeros_like(x)
    for s in range(coefs.shape[0]):
        x, old = dpmpp_step_plain(w, x, old, embin, trows[s], coefs[s], clamp)
    return x


def dpmpp_sampler_apply(w: PackedNet, x_T, embin, trows, coefs, clamp=False) -> torch.Tensor:
    """All N DPM-Solver++(2M) steps for ``x_T [BG, L]`` (fp32, at sigma_max
    scale) -> ``x_0 [BG, L]`` (fp32); operands from :func:`dpmpp_tables`."""
    _in_kernel_attention(w, "dpmpp_sampler_apply")
    if not on_cuda(x_T):
        return dpmpp_sampler_plain(w, x_T, embin, trows, coefs, clamp)
    d = w.dims
    BG, L = x_T.shape
    S = coefs.shape[0]
    _check_tables(w, x_T, embin, S, trows=trows, coefs=coefs)
    out = torch.empty((BG, L), dtype=torch.float32, device=x_T.device)
    DPMPP_KERNEL(x_T, DTYPE_CODE[w.dtype], ptr(x_T), ptr(embin), ptr(trows), ptr(coefs),
                 ptr(w.flat), ptr(w.layout), ptr(out), BG, S, L, d.emb_dim, d.cond_channels,
                 d.groups, w.cmax, int(bool(clamp)))
    return out


def dpmpp_step_apply(w: PackedNet, x, old, embin, trow, coef, clamp=False, out=None,
                     den_out=None, check=True):
    """One DPM-Solver++(2M) step of ``x [BG, L]`` (fp32) with the previous
    denoised estimate ``old [BG, L]`` -> ``(x_new, denoised)``, written into
    ``out`` / ``den_out`` when given. ``trow`` / ``coef`` are row s of
    :func:`dpmpp_tables`' tables; ``check`` as in :func:`ddim_step_apply`."""
    _in_kernel_attention(w, "dpmpp_step_apply")
    if not on_cuda(x):
        x_new, den = dpmpp_step_plain(w, x, old, embin, trow, coef, clamp)
        return (x_new if out is None else out.copy_(x_new),
                den if den_out is None else den_out.copy_(den))
    if check:
        _check_step(w, x, embin, dict(old=old), trow=trow, coef=coef)
    out, den_out = _out(out, x, check), _out(den_out, x, check)
    d = w.dims
    BG, L = x.shape
    DPMPP_STEP_KERNEL(x, DTYPE_CODE[w.dtype], ptr(x), ptr(old), ptr(embin), ptr(trow),
                      ptr(coef), ptr(w.flat), ptr(w.layout), ptr(out), ptr(den_out), BG, L,
                      d.emb_dim, d.cond_channels, d.groups, w.cmax, int(bool(clamp)))
    return out, den_out


def fused_sample_dpmpp(
    w: PackedNet, ed: ElucidatedDiffusion, input_emb: torch.Tensor, x_T: torch.Tensor,
    num_sample_steps: Optional[int] = None, clamp: bool = False,
    return_trajectory: bool = False,
):
    """EDM DPM-Solver++(2M): one whole-trajectory kernel launch, or with
    ``return_trajectory`` one ``dpmpp_step_kernel`` launch per step.

    Args:
        input_emb: ``[BG, Ce, emb]`` hoisted conditioning embedding.
        x_T: ``[BG, L]`` starting latents at sigma_max scale (float32).
    Returns:
        ``x_0 [BG, 1, L]`` float32; with ``return_trajectory`` the pair
        ``(x_0, trajectory [N, BG, 1, L])``, the state after each step
        (no x_T), as ``pallas_sampler.py:fused_sample_dpmpp`` returns them.
    """
    _in_kernel_attention(w, "fused_sample_dpmpp")
    N = num_sample_steps or ed.num_sample_steps
    with SAMPLER_TABLES.timed():
        embin, trows, coefs = dpmpp_tables(w, ed, input_emb, N)
    x_T = x_T.float().contiguous()
    if not return_trajectory:
        return dpmpp_sampler_apply(w, x_T, embin, trows, coefs, clamp)[:, None, :]
    if on_cuda(x_T):
        _check_tables(w, x_T, embin, N, trows=trows, coefs=coefs)
    traj = _trajectory(x_T, N)
    # the denoised estimates, in turns: step s reads dens[s % 2] (zeros at
    # the first step) and writes the other
    dens = torch.zeros((2,) + tuple(x_T.shape), dtype=torch.float32, device=x_T.device)
    x = x_T
    for s in range(N):
        dpmpp_step_apply(w, x, dens[s % 2], embin, trows[s], coefs[s], clamp, out=traj[s],
                         den_out=dens[(s + 1) % 2], check=False)
        x = traj[s]
    return traj[-1][:, None, :], traj[:, :, None, :]


# ---------------------------------------------------------------------------
# EDM: stochastic churn with the Heun correction
# ---------------------------------------------------------------------------


def churn_tables(w: PackedNet, ed: ElucidatedDiffusion, input_emb: torch.Tensor, N: int):
    """``churn_sampler_kernel``'s float32 operands besides ``x_T`` and the
    noise: ``embin``, ``trowsA`` / ``trowsB [N, Ce*E]`` (the time embedding
    at ``c_noise(sigma_hat)`` and ``c_noise(sigma_next)``) and ``coefA`` /
    ``coefB [N, 8]`` in the layout of ``pallas_sampler.py:298-307``:
    ``[cinA, cskipA, coutA, s_eps, dsc, 1/sigma_hat, 0, 0]`` and ``[cinB,
    cskipB, coutB, s_eps, dsc/2, 1/max(sigma_next, 1e-12), sigma_next != 0,
    0]``. ``S_noise`` is folded into ``s_eps``, so the noise stays a unit
    normal."""
    device = input_emb.device
    sigmas = ed.sample_schedule(N)
    gammas = ed.churn_gammas(sigmas)
    sig, sig_next, gamma = sigmas[:-1], sigmas[1:], gammas[:-1]
    sigma_hat = sig + gamma * sig
    s_eps = torch.sqrt(torch.clamp(sigma_hat**2 - sig**2, min=0.0)) * ed.S_noise
    dsc = sig_next - sigma_hat
    zeros = torch.zeros_like(sig)
    coefA = torch.stack([ed.c_in(sigma_hat), ed.c_skip(sigma_hat), ed.c_out(sigma_hat), s_eps,
                         dsc, 1.0 / sigma_hat, zeros, zeros], dim=-1)
    coefB = torch.stack([ed.c_in(sig_next), ed.c_skip(sig_next), ed.c_out(sig_next), s_eps,
                         0.5 * dsc, 1.0 / torch.clamp(sig_next, min=1e-12),
                         (sig_next != 0.0).float(), zeros], dim=-1)
    Ce = input_emb.shape[1]

    def trows(s):
        return compute_time_emb(w.aux, ed.c_noise(s).to(device)).repeat(1, Ce).contiguous()

    embin = input_emb.reshape(input_emb.shape[0], -1).float().contiguous()
    return (embin, trows(sigma_hat), trows(sig_next), coefA.float().to(device),
            coefB.float().to(device))


def churn_step_plain(w: PackedNet, x, embin, trowA, trowB, a, c, noise_s,
                     clamp: bool) -> torch.Tensor:
    """Plain version of ``churn_step_kernel``: one churn step, both legs,
    of ``x [BG, L]`` (fp32) with the coefficient rows ``a`` / ``c`` and the
    unit normal ``noise_s [BG, L]``; same rounding points (the network
    inputs ``cinA * x_hat`` and ``cinB * x_eul``)."""
    x_hat = x + a[3] * noise_s
    den = a[1] * x_hat + a[2] * _net_plain(w, a[0] * x_hat, embin, trowA)
    if clamp:
        den = den.clamp(-1.0, 1.0)
    d = (x_hat - den) * a[5]
    x_eul = x_hat + a[4] * d
    den = c[1] * x_eul + c[2] * _net_plain(w, c[0] * x_eul, embin, trowB)
    if clamp:
        den = den.clamp(-1.0, 1.0)
    d_prime = (x_eul - den) * c[5]
    return c[6] * (x_hat + c[4] * (d + d_prime)) + (1.0 - c[6]) * x_eul


def churn_sampler_plain(w: PackedNet, x_T, embin, trowsA, trowsB, coefA, coefB, noise,
                        clamp: bool) -> torch.Tensor:
    """Plain version of ``churn_sampler_kernel``: every step of
    :func:`churn_step_plain`."""
    x = x_T.float().clone()
    for s in range(coefA.shape[0]):
        x = churn_step_plain(w, x, embin, trowsA[s], trowsB[s], coefA[s], coefB[s], noise[s],
                             clamp)
    return x


def churn_sampler_apply(w: PackedNet, x_T, embin, trowsA, trowsB, coefA, coefB, noise,
                        clamp=False) -> torch.Tensor:
    """All N churn steps (two network evaluations each) for ``x_T [BG, L]``
    (fp32, at sigma_max scale) with per-step unit normals ``noise [N, BG,
    L]`` -> ``x_0 [BG, L]`` (fp32); operands from :func:`churn_tables`."""
    _in_kernel_attention(w, "churn_sampler_apply")
    if not on_cuda(x_T):
        return churn_sampler_plain(w, x_T, embin, trowsA, trowsB, coefA, coefB, noise, clamp)
    d = w.dims
    BG, L = x_T.shape
    S = coefA.shape[0]
    _check_tables(w, x_T, embin, S, trowsA=trowsA, trowsB=trowsB, coefA=coefA, coefB=coefB)
    check_operand("noise", noise, (S, BG, L), torch.float32, w.device)
    out = torch.empty((BG, L), dtype=torch.float32, device=x_T.device)
    CHURN_KERNEL(x_T, DTYPE_CODE[w.dtype], ptr(x_T), ptr(embin), ptr(trowsA), ptr(trowsB),
                 ptr(coefA), ptr(coefB), ptr(noise), ptr(w.flat), ptr(w.layout), ptr(out), BG,
                 S, L, d.emb_dim, d.cond_channels, d.groups, w.cmax, int(bool(clamp)))
    return out


def churn_step_apply(w: PackedNet, x, embin, trowA, trowB, coefA, coefB, noise_s,
                     clamp=False, out=None, check=True) -> torch.Tensor:
    """One churn step (two network evaluations) of ``x [BG, L]`` (fp32) with
    the unit normal ``noise_s [BG, L]`` -> ``[BG, L]`` (fp32), written into
    ``out`` when given. ``trowA`` / ``trowB`` / ``coefA`` / ``coefB`` are
    row s of :func:`churn_tables`' tables; ``check`` as in
    :func:`ddim_step_apply`."""
    _in_kernel_attention(w, "churn_step_apply")
    if not on_cuda(x):
        res = churn_step_plain(w, x, embin, trowA, trowB, coefA, coefB, noise_s, clamp)
        return res if out is None else out.copy_(res)
    if check:
        _check_step(w, x, embin, dict(noise_s=noise_s), trowA=trowA, trowB=trowB,
                    coefA=coefA, coefB=coefB)
    out = _out(out, x, check)
    d = w.dims
    BG, L = x.shape
    CHURN_STEP_KERNEL(x, DTYPE_CODE[w.dtype], ptr(x), ptr(noise_s), ptr(embin), ptr(trowA),
                      ptr(trowB), ptr(coefA), ptr(coefB), ptr(w.flat), ptr(w.layout), ptr(out),
                      BG, L, d.emb_dim, d.cond_channels, d.groups, w.cmax, int(bool(clamp)))
    return out


def fused_sample_churn(
    w: PackedNet, ed: ElucidatedDiffusion, input_emb: torch.Tensor, x_T: torch.Tensor,
    num_sample_steps: Optional[int] = None, clamp: bool = False,
    noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
    return_trajectory: bool = False,
):
    """EDM stochastic churn sampler (Heun): one whole-trajectory kernel
    launch, or with ``return_trajectory`` one ``churn_step_kernel`` launch
    per step.

    Args:
        input_emb: ``[BG, Ce, emb]`` hoisted conditioning embedding.
        x_T: ``[BG, L]`` starting latents at sigma_max scale (float32).
        noise: ``[N, BG, L]`` per-step unit normals; drawn from
            ``generator`` if None.
    Returns:
        ``x_0 [BG, 1, L]`` float32; with ``return_trajectory`` the pair
        ``(x_0, trajectory [N + 1, BG, 1, L])``, x_T first, as
        ``pallas_sampler.py:fused_sample_churn`` returns them.
    """
    _in_kernel_attention(w, "fused_sample_churn")
    N = num_sample_steps or ed.num_sample_steps
    with SAMPLER_TABLES.timed():
        embin, trowsA, trowsB, coefA, coefB = churn_tables(w, ed, input_emb, N)
    if noise is None:
        noise = torch.randn((N,) + tuple(x_T.shape), generator=generator, device=x_T.device)
    x_T, noise = x_T.float().contiguous(), noise.float().contiguous()
    if not return_trajectory:
        return churn_sampler_apply(w, x_T, embin, trowsA, trowsB, coefA, coefB, noise,
                                   clamp)[:, None, :]
    if on_cuda(x_T):
        _check_tables(w, x_T, embin, N, trowsA=trowsA, trowsB=trowsB, coefA=coefA,
                      coefB=coefB)
        check_operand("noise", noise, (N,) + tuple(x_T.shape), torch.float32, w.device)
    traj = _trajectory(x_T, N + 1)
    traj[0] = x_T
    for s in range(N):
        churn_step_apply(w, traj[s], embin, trowsA[s], trowsB[s], coefA[s], coefB[s], noise[s],
                         clamp, out=traj[s + 1], check=False)
    return traj[-1][:, None, :], traj[:, :, None, :]
