"""DDIM, eta 0, epsilon prediction, x_0 clipped to [-1, 1]: the program's
``sampler="ddim"`` on a DDPM schedule (``GaussianDiffusion1D``).

A reference sampler is found by the mix's ``sampler`` name and gives:

* ``evaluations(steps)``: the denoiser evaluations of one row's trajectory;
* ``draws(cfg, steps)``: the unit-normal draws a row takes besides x_T
  (the benchmark makes them from the seed and hands the same to both sides
  as ``noise [draws, rows, latent]``);
* ``sample(ddm, cfg, x, z_pc, steps, noise)``: ``x_T [R, L]`` -> ``x_0 [R, L]``.
"""

from __future__ import annotations

import torch


def evaluations(steps: int) -> int:
    return steps


def draws(cfg: dict, steps: int) -> int:
    return 0


def alphas_cumprod(cfg: dict) -> torch.Tensor:
    """The linear DDPM schedule's cumulative products, in float32."""
    if cfg["beta_schedule"] != "linear":
        raise ValueError(f"beta schedule {cfg['beta_schedule']!r}: the reference has linear")
    betas = torch.linspace(cfg["beta_start"], cfg["beta_end"], cfg["diffusion_timesteps"],
                           dtype=torch.float32)
    return torch.cumprod(1.0 - betas, dim=0)


def timesteps(cfg: dict, steps: int) -> list:
    """The descending strided grid, ``T - stride, ..., 0``, and the stride."""
    T = cfg["diffusion_timesteps"]
    stride = T // steps
    return list(range(0, T, stride))[::-1], stride


def sample(ddm, cfg: dict, x: torch.Tensor, z_pc: torch.Tensor, steps: int,
           noise=None) -> torch.Tensor:
    acp = alphas_cumprod(cfg).to(x.device)
    one = torch.ones((), device=x.device)
    grid, stride = timesteps(cfg, steps)
    x = x[:, None, :]
    for t in grid:
        t_row = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
        eps = ddm(x, t_row, z_pc)
        a_t = acp[t]
        a_prev = acp[t - stride] if t - stride >= 0 else one
        x0 = ((x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)).clamp(-1.0, 1.0)
        eps_eff = (x - torch.sqrt(a_t) * x0) / torch.sqrt(1.0 - a_t)
        x = torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps_eff
    return x[:, 0, :]
