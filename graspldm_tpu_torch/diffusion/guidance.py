"""Success guidance in the grasp latent space (torch).

Counterpart of :mod:`graspldm_tpu.diffusion.guidance`. The VAE decoder's
success head ``p(success | z_h, z_pc)`` is differentiable in the grasp
latent, so the gradient of ``sum_i log sigmoid(cls_logit_i)`` with respect
to a sampler step's x0 estimate steers the reverse process toward grasps
the decoder rates as successful. The samplers apply it as a score shift
(:meth:`..diffusion.GaussianDiffusion1D.sample`,
:class:`..diffusion.ElucidatedDiffusion`); classifier-free guidance lives
in the pipeline (``ldm_generate(cfg_scale=...)``).

The gradient is autograd through the port's plain ``GraspCVAE.decode``
(an ``nn.Module``), as the JAX package differentiates its flax decoder:
the decoder kernels define no backward. Like the flax decoder, the plain
one computes its core in the declared ``decoder_dtype``, so a bf16
flagship's gradient carries the same bf16 rounding as JAX's.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

__all__ = ["GuidanceFn", "make_success_guidance"]

# x0 estimate [B, 1, D] -> grad of the guidance log-likelihood, same shape
GuidanceFn = Callable[[torch.Tensor], torch.Tensor]


def make_success_guidance(vae, z_pc_rep: torch.Tensor) -> GuidanceFn:
    """Gradient of the decoder's success head with respect to the latent.

    Args:
        vae: a :class:`..models.GraspCVAE` (in eval mode).
        z_pc_rep: ``[B*G, Ce, D_pc]`` conditioning latents, repeated per
            grasp: the tensor the sampler conditions on.

    Returns:
        ``fn(x0 [B*G, 1, D]) -> grad [B*G, 1, D]`` of ``sum_i log
        sigmoid(cls_logit_i)``; rows are independent, so the sum's
        gradient is each row's own. It works inside the samplers'
        ``torch.no_grad``: the gradient is taken on a detached leaf under
        ``torch.enable_grad``.
    """
    z_pc = z_pc_rep.detach()

    def fn(x0: torch.Tensor) -> torch.Tensor:
        with torch.enable_grad():
            z_h = x0[:, 0, :].detach().float().requires_grad_(True)
            logits = vae.decode(z_h, z_pc)[1]
            (grad,) = torch.autograd.grad(F.logsigmoid(logits.float()).sum(), z_h)
        return grad.to(x0.dtype)[:, None, :]

    return fn
