"""Gaussian latent diffusion sampler as a Python loop (torch).

Counterpart of :meth:`graspldm_tpu.diffusion.gaussian.GaussianDiffusion1D.
sample`. torch cannot reproduce ``jax.random``, so the starting latents
``x_T`` and the DDPM per-step noise are explicit tensors; when they are not
given they are drawn from the caller's ``torch.Generator``. The guided
generation path runs this loop (one denoiser call per step); the unguided
one runs the whole trajectory as one kernel launch instead
(:mod:`..models.cuda_sampler`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .schedules import DiffusionSchedule

__all__ = ["GaussianDiffusion1D"]

DenoiseFn = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion1D:
    schedule: DiffusionSchedule
    n_dims: int
    variance_type: str = "fixed_large"

    @torch.no_grad()
    def sample(
        self,
        denoise_fn: DenoiseFn,
        batch_size: int,
        z_cond: Optional[torch.Tensor] = None,
        num_inference_steps: Optional[int] = None,
        sampler: str = "ddpm",
        x_T: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
        return_trajectory: bool = False,
        guidance_fn=None,
        guidance_scale: float = 1.0,
    ):
        """Reverse diffusion from ``x_T`` (``[B, 1, D]``) to ``x_0``.

        ``guidance_fn`` (:mod:`.guidance`: ``x0 -> grad log p(y | x0)``)
        shifts each step's score: with the x0 estimate from the frozen
        epsilon, ``eps <- eps - guidance_scale * sqrt(1 - acp_t) /
        sqrt(acp_t) * g``.

        ``noise`` is ``[len(grid), B, 1, D]`` (DDPM only): one draw per step
        of ``timestep_grid(S)``, which has more than S entries when S does
        not divide T; step ``s`` uses ``noise[s]``.

        Returns ``x_0``; with ``return_trajectory`` the pair ``(x_0,
        trajectory [len(grid) + 1, B, 1, D])``, x_T first, as the JAX
        package's ``sample(return_trajectory=True)`` returns them.
        """
        if sampler not in ("ddpm", "ddim"):
            raise ValueError(f"Unknown sampler: {sampler}")
        T = self.schedule.num_train_timesteps
        S = num_inference_steps or T
        ts = self.schedule.timestep_grid(S).tolist()
        stride = T // S
        shape = (batch_size, 1, self.n_dims)
        if x_T is None:
            x_T = torch.randn(shape, generator=generator, device=device)
        if sampler == "ddpm" and noise is None:
            noise = torch.randn((len(ts),) + shape, generator=generator, device=x_T.device)
        x = x_T
        traj = [x]
        for s, t in enumerate(ts):
            t_batch = torch.full((batch_size,), t, dtype=torch.int64, device=x.device)
            eps = denoise_fn(x, t_batch, z_cond)
            if guidance_fn is not None:
                acp_t = self.schedule.alphas_cumprod[t].to(x.device)
                g = guidance_fn(self.schedule.pred_x0_from_eps(x, eps, acp_t))
                eps = eps - (guidance_scale * torch.sqrt(1.0 - acp_t) / torch.sqrt(acp_t)) * g
            if sampler == "ddim":
                x = self.schedule.ddim_step(x, eps, t, t - stride)
            else:
                x = self.schedule.ddpm_step(
                    x, eps, t, t - stride, noise[s], self.variance_type
                )
            traj.append(x)
        return (x, torch.stack(traj)) if return_trajectory else x
