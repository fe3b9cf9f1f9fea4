"""The port's micro-benchmarks: the counterparts of the JAX package's
``tools/bench_mm.py``, ``tools/bench_silu.py`` and ``tools/bench_repeat.py``.

Each module holds the plain PyTorch version of its chain in every form, the
wrapper that runs that version for a CPU tensor and launches the Hopper
kernel (``csrc/microbench.cu``) for a CUDA tensor, the kernel's launch
handle, the timing function its ``main()`` calls, and ``main()`` itself::

    python -m graspldm_tpu_torch.tools.bench_mm [R_total]
    python -m graspldm_tpu_torch.tools.bench_silu [R_total] [width]
    python -m graspldm_tpu_torch.tools.bench_repeat [R_total]

``main()`` runs on the card and raises without one
(:func:`graspldm_tpu_torch.flagship.resolve_device`), unless ``--device
cpu`` is given (the plain versions, for the tests).
"""

from __future__ import annotations

import argparse

import torch

__all__ = ["bf16_bits", "aligned", "tool_parser"]


def bf16_bits(value: float) -> int:
    """The bits of ``value`` rounded to bfloat16 (to nearest, ties to even),
    as the unsigned 16-bit integer a kernel takes as a runtime argument."""
    t = torch.tensor([value], dtype=torch.float32).to(torch.bfloat16)
    return int(t.view(torch.int16).item()) & 0xFFFF


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernels' vector loads),
    copied only where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def tool_parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    p.add_argument("R_total", nargs="?", type=int, default=8192, help="rows (any count)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu (plain versions)")
    p.add_argument("--iters", type=int, default=10, help="timed calls per form")
    return p
