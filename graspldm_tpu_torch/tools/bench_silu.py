"""Micro-benchmark: three lowerings of SiLU on bfloat16.

The counterpart of ``tools/bench_silu.py``. A dependent chain of ``REPS``
SiLUs on ``x [R, W]`` bfloat16 (defaults 8192 x 2048, inputs normal x 3);
after each rep ``x = bf16(y * bf16(MULT))``. Forms:

    f32     : upcast, x * sigmoid(x) in float32, one rounding
    bf16exp : e = exp(-x), then x / (1 + e), each op rounded to bf16
    mixexp  : float32 exp and float32 quotient of the bf16 input, one
              rounding

``bf16(0.999)`` is 1.0; the kernel takes the multiplier's bits at run time.
:func:`silu_chain_apply` launches ``silu_chain_kernel``
(``csrc/microbench.cu``) for a CUDA tensor and runs :func:`plain_chain` for
a CPU one.

    python -m graspldm_tpu_torch.tools.bench_silu [R_total] [width] [--device cpu]
"""

from __future__ import annotations

from typing import Iterator

import torch

from ..cuda_build import KernelCounter, on_cuda, ptr
from ..utils.profiling import device_line, timeit
from ..flagship import resolve_device
from . import aligned, bf16_bits, tool_parser

__all__ = ["W", "REPS", "MULT", "FORMS", "SILU_CHAIN_KERNEL", "make_inputs", "plain_chain",
           "silu_chain_apply", "bench", "line", "main"]

W = 2048
REPS = 12
MULT = 0.999
FORMS = ("f32", "bf16exp", "mixexp")
FORM_CODE = {f: i for i, f in enumerate(FORMS)}
SILU_CHAIN_KERNEL = KernelCounter("silu_chain_kernel", "gl_silu_chain")


def make_inputs(R: int, width: int = W, device=None, seed: int = 0) -> torch.Tensor:
    """``x [R, width]`` bf16: standard normals rounded to bf16, times 3 in
    bf16, from a seeded generator on ``device``."""
    dev = torch.device(device or "cpu")
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((R, width), generator=gen, device=dev).to(torch.bfloat16) * 3.0


def plain_chain(x: torch.Tensor, form: str, reps: int = REPS) -> torch.Tensor:
    """The chain in plain PyTorch: bf16 of ``x``'s shape. bf16 tensor ops
    compute in float32 and round their result, as XLA's do."""
    m = torch.tensor(MULT, dtype=torch.bfloat16, device=x.device)
    for _ in range(reps):
        if form == "f32":
            xf = x.float()
            y = (xf * torch.sigmoid(xf)).to(torch.bfloat16)
        elif form == "bf16exp":
            e = torch.exp(-x)
            y = x / (1.0 + e)
        elif form == "mixexp":
            xf = x.float()
            y = (xf / (1.0 + torch.exp(-xf))).to(torch.bfloat16)
        else:
            raise ValueError(f"form must be one of {FORMS}, got {form!r}")
        x = y * m
    return x


def silu_chain_apply(x: torch.Tensor, form: str, reps: int = REPS) -> torch.Tensor:
    """The chain of ``x`` (bf16, any shape): bf16 of its shape."""
    if form not in FORM_CODE:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bf16, got {x.dtype}")
    if not on_cuda(x):
        return plain_chain(x, form, reps)
    x = aligned(x)
    out = torch.empty_like(x)
    SILU_CHAIN_KERNEL(x, FORM_CODE[form], ptr(x), ptr(out), x.numel(), reps, bf16_bits(MULT))
    return out


def bench(R_total: int = 8192, width: int = W, device=None, iters: int = 10,
          seed: int = 0) -> Iterator[dict]:
    """The tool's run: each form once for its result, then timed over
    ``iters`` calls after one warm-up (``iters + 2`` launches a form).
    Yields ``{"form", "seconds" (per SiLU), "err", "out"}`` form by form,
    the error max |y - ref| against the first form. The input is
    :func:`make_inputs` of ``seed``."""
    dev = resolve_device(device)
    x = make_inputs(R_total, width, dev, seed)
    ref = None
    for form in FORMS:
        y = silu_chain_apply(x, form)
        err = 0.0 if ref is None else float((y.float() - ref.float()).abs().max())
        ref = y if ref is None else ref
        t = timeit(silu_chain_apply, x, form, iters=iters) / REPS
        yield dict(form=form, seconds=t, err=err, out=y)


def line(r: dict) -> str:
    """One form's printed line, as the JAX tool prints it."""
    return f"{r['form']:8s}: {r['seconds'] * 1e6:7.1f} us/call  max|err vs f32|={r['err']:.2e}"


def main(argv=None) -> None:
    p = tool_parser(__doc__)
    p.add_argument("width", nargs="?", type=int, default=W, help="columns")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    print(device_line(dev), flush=True)
    for r in bench(a.R_total, a.width, dev, a.iters):
        print(line(r), flush=True)


if __name__ == "__main__":
    main()
