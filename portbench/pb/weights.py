"""Random weights from the seed, made on the device in the reference's
state-dict key space, to be loaded into the reference and the program.

Dense and conv weights and biases are uniform in +-1/sqrt(fan_in) (the
scale of PyTorch's default init); norm gains 1 and shifts 0; BatchNorm
running statistics reset; the frozen random Fourier weights standard
normal. All uniform entries come from one ``torch.rand`` call and all
normal ones from one ``torch.randn`` call on a ``torch.Generator`` on the
device.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from reference import model as ref

from .traffic import derived_seed


@torch.no_grad()
def fill_(modules, seed: int, device) -> None:
    """Draw every parameter and buffer of ``modules`` (reference modules
    with storage on ``device``) from ``seed``."""
    uniform, bounds, normal, done = [], [], [], set()
    for root in modules:
        for m in root.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv3d)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                for p in (m.weight, m.bias):
                    if p is not None:
                        uniform.append(p)
                        bounds.append(bound)
            elif isinstance(m, (nn.GroupNorm, nn.BatchNorm1d)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, nn.BatchNorm1d):
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
                    m.num_batches_tracked.zero_()
            elif isinstance(m, ref.ChannelLayerNorm):
                m.g.fill_(1.0)
            elif isinstance(m, ref.RandomFourierEmb):
                normal.append(m.weights)
            else:
                continue
            done.update(id(t) for t in (*m.parameters(recurse=False), *m.buffers(recurse=False)))
    for root in modules:
        for name, t in (*root.named_parameters(), *root.named_buffers()):
            if id(t) not in done:
                raise ValueError(f"no rule draws {name}")
    gen = torch.Generator(device=device)
    gen.manual_seed(derived_seed(seed, "weights", 0))
    sizes = [p.numel() for p in uniform]
    scale = torch.repeat_interleave(torch.tensor(bounds, device=device),
                                    torch.tensor(sizes, device=device))
    flat = (torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0) * scale
    torch._foreach_copy_(uniform, [v.view_as(p) for v, p in zip(flat.split(sizes), uniform)])
    if normal:
        sizes = [p.numel() for p in normal]
        flat = torch.randn(sum(sizes), generator=gen, device=device)
        torch._foreach_copy_(normal, [v.view_as(p) for v, p in zip(flat.split(sizes), normal)])


def make(cfg: dict, seed: int, device, with_denoiser: bool = True):
    """The reference ``(vae, ddm | None)`` on ``device`` with the seed's weights."""
    vae, ddm = ref.build(cfg, device, with_denoiser)
    fill_([m for m in (vae, ddm) if m is not None], seed, device)
    return vae, ddm
