"""Noise schedules and DDPM/DDIM reverse steps (torch).

Counterpart of :mod:`graspldm_tpu.diffusion.schedules`: the beta schedules
``linear``, ``scaled_linear`` and ``squaredcos_cap_v2`` (alias ``cosine``),
rounded as the JAX package rounds them. ``alphas_cumprod`` stays in
float32, as in the JAX package (x64 off there): DDIM parity drifts if it is
computed in float64 here.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["DiffusionSchedule", "make_beta_schedule", "BETA_SCHEDULES"]

BETA_SCHEDULES = ("linear", "scaled_linear", "squaredcos_cap_v2", "cosine")


def make_beta_schedule(schedule: str, num_steps: int, beta_start: float,
                       beta_end: float) -> torch.Tensor:
    """``[num_steps]`` float32 betas, as the JAX package's
    ``make_beta_schedule``. ``scaled_linear`` squares a float32 linspace of
    square roots in float32; the cosine schedule is computed in Python
    floats (float64), capped at 0.999, then cast to float32. (XLA folds
    ``jnp.linspace`` into other float32 arithmetic than ``torch.linspace``:
    its entries can differ by 1 ulp, so the linear betas by 1 ulp and the
    scaled-linear ones by up to 4.)"""
    if schedule == "linear":
        return torch.linspace(beta_start, beta_end, num_steps, dtype=torch.float32)
    if schedule == "scaled_linear":
        return torch.linspace(beta_start ** 0.5, beta_end ** 0.5, num_steps,
                              dtype=torch.float32) ** 2
    if schedule in ("squaredcos_cap_v2", "cosine"):
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

        return torch.tensor(
            [min(1.0 - alpha_bar((i + 1) / num_steps) / alpha_bar(i / num_steps), 0.999)
             for i in range(num_steps)], dtype=torch.float32)
    raise ValueError(f"Unknown beta schedule: {schedule}")


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed forward-process constants (float32, on ``betas.device``)."""

    num_train_timesteps: int
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    clip_sample: bool = True
    clip_sample_range: float = 1.0

    @classmethod
    def create(
        cls,
        num_steps: int = 1000,
        beta_schedule: str = "linear",
        beta_start: float = 1e-4,
        beta_end: float = 0.02,
        clip_sample: bool = True,
    ) -> "DiffusionSchedule":
        betas = make_beta_schedule(beta_schedule, num_steps, beta_start, beta_end)
        return cls(
            num_train_timesteps=num_steps,
            betas=betas,
            alphas_cumprod=torch.cumprod(1.0 - betas, dim=0),
            clip_sample=clip_sample,
        )

    def timestep_grid(self, num_inference_steps: int) -> torch.Tensor:
        """Descending strided timesteps, ``reversed(range(0, T, T // S))``."""
        stride = self.num_train_timesteps // num_inference_steps
        return torch.arange(0, self.num_train_timesteps, stride).flip(0)

    def _acp(self, t: int) -> torch.Tensor:
        return self.alphas_cumprod[t] if t >= 0 else torch.ones(())

    def _clip(self, x0: torch.Tensor) -> torch.Tensor:
        if self.clip_sample:
            return x0.clamp(-self.clip_sample_range, self.clip_sample_range)
        return x0

    @staticmethod
    def pred_x0_from_eps(x_t, eps, acp_t):
        return (x_t - torch.sqrt(1.0 - acp_t) * eps) / torch.sqrt(acp_t)

    def ddim_step(self, x_t, eps, t: int, prev_t: int) -> torch.Tensor:
        """One deterministic DDIM step (eta = 0, epsilon prediction)."""
        acp_t = self._acp(t).to(x_t.device)
        acp_prev = self._acp(prev_t).to(x_t.device)
        x0 = self._clip(self.pred_x0_from_eps(x_t, eps, acp_t))
        eps_eff = (x_t - torch.sqrt(acp_t) * x0) / torch.sqrt(1.0 - acp_t)
        return torch.sqrt(acp_prev) * x0 + torch.sqrt(1.0 - acp_prev) * eps_eff

    def ddpm_step(
        self, x_t, eps, t: int, prev_t: int, noise, variance_type="fixed_large"
    ) -> torch.Tensor:
        """One ancestral DDPM step; no noise is added at the last step."""
        acp_t = self._acp(t).to(x_t.device)
        acp_prev = self._acp(prev_t).to(x_t.device)
        current_alpha = acp_t / acp_prev
        current_beta = 1.0 - current_alpha
        x0 = self._clip(self.pred_x0_from_eps(x_t, eps, acp_t))
        coeff_x0 = torch.sqrt(acp_prev) * current_beta / (1.0 - acp_t)
        coeff_xt = torch.sqrt(current_alpha) * (1.0 - acp_prev) / (1.0 - acp_t)
        mean = coeff_x0 * x0 + coeff_xt * x_t
        if variance_type in ("fixed_small", "fixed_small_log"):
            variance = torch.clamp(
                (1.0 - acp_prev) / (1.0 - acp_t) * current_beta, min=1e-20
            )
        elif variance_type in ("fixed_large", "fixed_large_log"):
            variance = current_beta
        else:
            raise ValueError(f"Unsupported variance type: {variance_type}")
        if prev_t < 0:
            return mean
        return mean + torch.sqrt(torch.clamp(variance, min=0.0)) * noise
