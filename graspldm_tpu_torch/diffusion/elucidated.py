"""Elucidated diffusion (EDM, Karras et al. 2206.00364) samplers (torch).

Counterpart of :class:`graspldm_tpu.diffusion.elucidated.ElucidatedDiffusion`
for sampling: sigma-space diffusion with the EDM preconditioning
(c_skip/c_out/c_in/c_noise), the rho-7 sigma schedule, the stochastic churn
sampler with its 2nd-order Heun correction, and DPM-Solver++(2M). Both
samplers are Python loops around a ``denoise_fn``; the generation path runs
them as one kernel launch instead (:mod:`..models.cuda_sampler`).

torch cannot reproduce ``jax.random``, so the starting latents ``x_T``
(already scaled by sigma_max) and the churn sampler's per-step unit
normals are explicit tensors; when they are not given they are drawn from
the caller's ``torch.Generator``. With ``return_trajectory`` each sampler
also returns its states as the JAX package's does. ``sample`` dispatches
to either, as the JAX package's does. A ``guidance_fn``
(:mod:`.guidance`) shifts every preconditioned estimate; the guided
generation path runs these loops. The training loss waits for the training
slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

__all__ = ["ElucidatedDiffusion"]

DenoiseFn = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ElucidatedDiffusion:
    """EDM over 1-D latents ``[B, 1, D]``.

    The ``denoise_fn`` passed to the samplers is the RAW network
    ``(x, time, z_cond) -> out``; preconditioning wraps it here. The
    defaults are the JAX package's (and its reference's).
    """

    n_dims: int
    channels: int = 1
    num_sample_steps: int = 32
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    sigma_data: float = 0.5
    rho: float = 7.0
    P_mean: float = -1.2
    P_std: float = 1.2
    S_churn: float = 80.0
    S_tmin: float = 0.05
    S_tmax: float = 50.0
    S_noise: float = 1.003

    # ---- preconditioning (Table 1); sigma is a float32 tensor ----

    def c_skip(self, sigma: torch.Tensor) -> torch.Tensor:
        return (self.sigma_data**2) / (sigma**2 + self.sigma_data**2)

    def c_out(self, sigma: torch.Tensor) -> torch.Tensor:
        return sigma * self.sigma_data * torch.rsqrt(self.sigma_data**2 + sigma**2)

    def c_in(self, sigma: torch.Tensor) -> torch.Tensor:
        return torch.rsqrt(sigma**2 + self.sigma_data**2)

    def c_noise(self, sigma: torch.Tensor) -> torch.Tensor:
        return torch.log(torch.clamp(sigma, min=1e-20)) * 0.25

    def preconditioned(self, denoise_fn: DenoiseFn, noised_x: torch.Tensor,
                       sigma: torch.Tensor, z_cond: Optional[torch.Tensor],
                       clamp: bool = False) -> torch.Tensor:
        """Denoised estimate D(x; sigma) (eq. 7). ``sigma`` is ``[B]``."""
        padded = sigma[:, None, None]
        out = denoise_fn(self.c_in(padded) * noised_x, self.c_noise(sigma), z_cond)
        out = self.c_skip(padded) * noised_x + self.c_out(padded) * out
        return out.clamp(-1.0, 1.0) if clamp else out

    # ---- schedule (eq. 5) ----

    def sample_schedule(self, num_sample_steps: Optional[int] = None) -> torch.Tensor:
        """``[N+1]`` float32 sigmas from sigma_max down to sigma_min, then 0.

        Raises ``ValueError`` for N < 2: eq. 5 divides by N - 1 (the JAX
        package returns NaN sigmas there)."""
        N = num_sample_steps or self.num_sample_steps
        if N < 2:
            raise ValueError(f"the EDM schedule needs at least 2 steps, got {N}")
        inv_rho = 1.0 / self.rho
        steps = torch.arange(N, dtype=torch.float32)
        sigmas = (
            self.sigma_max**inv_rho
            + steps / (N - 1) * (self.sigma_min**inv_rho - self.sigma_max**inv_rho)
        ) ** self.rho
        return torch.cat([sigmas, torch.zeros(1)])

    def churn_gammas(self, sigmas: torch.Tensor) -> torch.Tensor:
        """Churn factor per sigma of an ``N``-step schedule (``[N+1]``)."""
        N = sigmas.shape[0] - 1
        g = min(self.S_churn / N, math.sqrt(2.0) - 1.0)
        inside = (sigmas >= self.S_tmin) & (sigmas <= self.S_tmax)
        return torch.where(inside, torch.full_like(sigmas, g), torch.zeros_like(sigmas))

    # ---- samplers ----

    def _start(self, sigmas, batch_size, x_T, generator, device):
        if x_T is not None:
            return x_T.float()
        shape = (batch_size, self.channels, self.n_dims)
        return sigmas[0].item() * torch.randn(shape, generator=generator, device=device)

    def _guided(self, denoise_fn: DenoiseFn, noised_x: torch.Tensor, sigma: torch.Tensor,
                z_cond: Optional[torch.Tensor], clamp: bool, guidance_fn,
                guidance_scale: float) -> torch.Tensor:
        """The denoised estimate with the latent-space guidance shift: the
        network's output is the x0 estimate, so ``score += s * g(D)`` with
        ``score = (D - x) / sigma^2`` is ``D <- D + s * sigma^2 * g(D)``."""
        out = self.preconditioned(denoise_fn, noised_x, sigma, z_cond, clamp)
        if guidance_fn is not None:
            out = out + guidance_scale * (sigma**2)[:, None, None] * guidance_fn(out)
        return out

    def sample(
        self, denoise_fn: DenoiseFn, batch_size: int, z_cond: Optional[torch.Tensor] = None,
        num_sample_steps: Optional[int] = None, use_dpmpp: bool = False, clamp: bool = False,
        return_trajectory: bool = False, guidance_fn=None, guidance_scale: float = 1.0, *,
        x_T: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None, device=None,
    ):
        """The JAX package's entry point, in its argument order:
        :meth:`sample_dpmpp` with ``use_dpmpp``, else :meth:`sample_churn`.
        The draws the JAX package takes from its ``rng`` are explicit here
        (``x_T``, and the churn sampler's ``noise``) or come from
        ``generator``. Returns what the chosen sampler returns. DPM++ draws
        no noise after ``x_T``, so ``noise`` with ``use_dpmpp`` raises
        ``ValueError``."""
        kw = dict(z_cond=z_cond, num_sample_steps=num_sample_steps, clamp=clamp, x_T=x_T,
                  generator=generator, device=device, return_trajectory=return_trajectory,
                  guidance_fn=guidance_fn, guidance_scale=guidance_scale)
        if not use_dpmpp:
            return self.sample_churn(denoise_fn, batch_size, noise=noise, **kw)
        if noise is not None:
            raise ValueError("sample(use_dpmpp=True) takes no noise: DPM-Solver++(2M) draws "
                             "nothing after x_T")
        return self.sample_dpmpp(denoise_fn, batch_size, **kw)

    @torch.no_grad()
    def sample_churn(
        self, denoise_fn: DenoiseFn, batch_size: int, z_cond: Optional[torch.Tensor] = None,
        num_sample_steps: Optional[int] = None, clamp: bool = False,
        x_T: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None, device=None,
        return_trajectory: bool = False, guidance_fn=None, guidance_scale: float = 1.0,
    ):
        """Stochastic churn sampler with the Heun 2nd-order correction
        (Algorithm 2). ``noise [N, B, 1, D]`` holds each step's unit normal
        (scaled by ``S_noise`` here). Returns ``x_0``; with
        ``return_trajectory`` the pair ``(x_0, trajectory [N + 1, B, 1,
        D])``, x_T first. Each step evaluates ``denoise_fn`` (and
        ``guidance_fn``) twice, the last step once: 2N - 1 evaluations."""
        guide = (guidance_fn, guidance_scale)
        N = num_sample_steps or self.num_sample_steps
        sigmas = self.sample_schedule(N)
        gammas = self.churn_gammas(sigmas)
        x = self._start(sigmas, batch_size, x_T, generator, device)
        if noise is None:
            noise = torch.randn((N,) + tuple(x.shape), generator=generator, device=x.device)

        def full(s: float) -> torch.Tensor:
            return torch.full((x.shape[0],), s, dtype=torch.float32, device=x.device)

        traj = [x]
        for i in range(N):
            sigma, sigma_next = sigmas[i].item(), sigmas[i + 1].item()
            eps = self.S_noise * noise[i].reshape(x.shape).float()
            sigma_hat = sigma + gammas[i].item() * sigma
            x_hat = x + math.sqrt(max(sigma_hat**2 - sigma**2, 0.0)) * eps
            denoised = self._guided(denoise_fn, x_hat, full(sigma_hat), z_cond, clamp, *guide)
            d = (x_hat - denoised) / sigma_hat
            x_euler = x_hat + (sigma_next - sigma_hat) * d
            if sigma_next == 0.0:  # the 2nd-order correction is skipped
                x = x_euler
            else:
                denoised_next = self._guided(
                    denoise_fn, x_euler, full(sigma_next), z_cond, clamp, *guide)
                d_prime = (x_euler - denoised_next) / sigma_next
                x = x_hat + 0.5 * (sigma_next - sigma_hat) * (d + d_prime)
            traj.append(x)
        return (x, torch.stack(traj)) if return_trajectory else x

    @torch.no_grad()
    def sample_dpmpp(
        self, denoise_fn: DenoiseFn, batch_size: int, z_cond: Optional[torch.Tensor] = None,
        num_sample_steps: Optional[int] = None, clamp: bool = False,
        x_T: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
        device=None, return_trajectory: bool = False, guidance_fn=None,
        guidance_scale: float = 1.0,
    ):
        """DPM-Solver++(2M) (2211.01095), deterministic after ``x_T``.
        Returns ``x_0``; with ``return_trajectory`` the pair ``(x_0,
        trajectory [N, B, 1, D])``, the state after each step (no x_T)."""
        N = num_sample_steps or self.num_sample_steps
        sigmas = self.sample_schedule(N)
        x = self._start(sigmas, batch_size, x_T, generator, device)

        def t_fn(s: float) -> float:
            return -math.log(max(s, 1e-20))

        old, traj = None, []
        for i in range(N):
            sigma, sigma_next = sigmas[i].item(), sigmas[i + 1].item()
            sig_b = torch.full((x.shape[0],), sigma, dtype=torch.float32, device=x.device)
            denoised = self._guided(denoise_fn, x, sig_b, z_cond, clamp, guidance_fn,
                                    guidance_scale)
            h = t_fn(sigma_next) - t_fn(sigma)
            if old is None or sigma_next == 0.0:  # first order
                denoised_d = denoised
            else:
                h_last = t_fn(sigma) - t_fn(sigmas[i - 1].item())
                r = h_last / (h if h != 0 else 1e-20)
                gamma = -1.0 / (2.0 * (r if r != 0 else 1e-20))
                denoised_d = (1.0 - gamma) * denoised + gamma * old
            ratio = max(sigma_next, 1e-20) / max(sigma, 1e-20)
            x = ratio * x - math.expm1(-h) * denoised_d
            old = denoised
            traj.append(x)
        return (x, torch.stack(traj)) if return_trajectory else x
