"""Linear-beta noise schedule and DDPM/DDIM reverse steps (torch).

Counterpart of :mod:`graspldm_tpu.diffusion.schedules`. ``alphas_cumprod``
stays in float32, as in the JAX package (x64 off there): DDIM parity drifts
if it is computed in float64 here.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["DiffusionSchedule"]


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
        if beta_schedule != "linear":
            raise NotImplementedError(
                f"beta_schedule={beta_schedule!r}: the port has the linear "
                "schedule only"
            )
        betas = torch.linspace(beta_start, beta_end, num_steps, dtype=torch.float32)
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
