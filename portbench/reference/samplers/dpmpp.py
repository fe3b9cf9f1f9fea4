"""EDM (Karras et al., arXiv 2206.00364) sampled by DPM-Solver++(2M) (Lu et
al., arXiv 2211.01095): the program's ``sampler="dpmpp"`` on an
``ElucidatedDiffusion``, as GraspLDM's ``elucidated_ddm`` mode runs it.

With sigma_data = s_d, Karras et al.'s Table 1 preconditions the raw
network F:

    D(x; sigma) = c_skip(sigma) x + c_out(sigma) F(c_in(sigma) x, c_noise(sigma))
    c_skip = s_d^2 / (sigma^2 + s_d^2),  c_out = sigma s_d / sqrt(sigma^2 + s_d^2),
    c_in = 1 / sqrt(sigma^2 + s_d^2),    c_noise = ln(sigma) / 4

over the schedule of their eq. 5, N steps:

    sigma_i = (sigma_max^(1/rho) + i / (N - 1) (sigma_min^(1/rho) - sigma_max^(1/rho)))^rho,
    i < N;  sigma_N = 0

DPM-Solver++(2M) (Lu et al., Algorithm 2, in lambda = -ln sigma, as EDM's
alpha is 1), with h_i = lambda_{i+1} - lambda_i and D_i = D(x_i; sigma_i):

    x_{i+1} = (sigma_{i+1} / sigma_i) x_i - (e^(-h_i) - 1) D'_i
    D'_0 = D_0;  D'_i = (1 + 1 / (2 r_i)) D_i - 1 / (2 r_i) D_{i-1},  r_i = h_{i-1} / h_i

Departures from the published description, each as GraspLDM's code (and
k-diffusion's ``sample_dpmpp_2m``) has it:

* the last step, to sigma_N = 0, is first order: h is infinite there, and
  the update is its limit, ``x_N = D_{N-1}``; Lu et al. end at a sigma
  above 0 and keep the second order;
* no clamp of D (``clamp=False``, the inference tool's default);
* the schedule and the step's scalars are computed in float64 on the host
  and applied as scalars of the states' dtype: float32 in the benchmark,
  whose x_T and weights are float32 (a float64 copy of the modules and
  x_T runs the whole trajectory in float64).

A reference sampler is found by the mix's ``sampler`` name and gives
``evaluations(steps)``, ``draws(cfg, steps)`` and ``sample(ddm, cfg, x,
z_pc, steps, noise)`` (see ``ddim.py``). ``x`` is x_T at sigma_max scale.
"""

from __future__ import annotations

import math

import torch


def evaluations(steps: int) -> int:
    return steps


def draws(cfg: dict, steps: int) -> int:
    return 0


def sigmas(cfg: dict, steps: int) -> list:
    """Karras et al.'s eq. 5: ``steps`` sigmas from sigma_max down to
    sigma_min, then 0."""
    if steps < 2:
        raise ValueError(f"the EDM schedule needs at least 2 steps, got {steps}")
    lo, hi = cfg["sigma_min"] ** (1.0 / cfg["rho"]), cfg["sigma_max"] ** (1.0 / cfg["rho"])
    return [(hi + i / (steps - 1) * (lo - hi)) ** cfg["rho"] for i in range(steps)] + [0.0]


def denoise(ddm, cfg: dict, x: torch.Tensor, sigma: float, z_pc: torch.Tensor) -> torch.Tensor:
    """D(x; sigma) for ``x [R, 1, L]`` (Table 1's preconditioning)."""
    s_d = cfg["sigma_data"]
    c_skip = s_d ** 2 / (sigma ** 2 + s_d ** 2)
    c_out = sigma * s_d / math.sqrt(sigma ** 2 + s_d ** 2)
    c_in = 1.0 / math.sqrt(sigma ** 2 + s_d ** 2)
    c_noise = torch.full((x.shape[0],), math.log(sigma) / 4.0, dtype=x.dtype, device=x.device)
    return c_skip * x + c_out * ddm(c_in * x, c_noise, z_pc)


def sample(ddm, cfg: dict, x: torch.Tensor, z_pc: torch.Tensor, steps: int,
           noise=None) -> torch.Tensor:
    sig = sigmas(cfg, steps)
    x = x[:, None, :]
    old, h_last = None, None
    for i in range(steps):
        den = denoise(ddm, cfg, x, sig[i], z_pc)
        if sig[i + 1] == 0.0:
            x = den
            break
        h = math.log(sig[i]) - math.log(sig[i + 1])
        if old is None:
            d = den
        else:
            r = h_last / h
            d = (1.0 + 1.0 / (2.0 * r)) * den - 1.0 / (2.0 * r) * old
        x = (sig[i + 1] / sig[i]) * x - math.expm1(-h) * d
        old, h_last = den, h
    return x[:, 0, :]
