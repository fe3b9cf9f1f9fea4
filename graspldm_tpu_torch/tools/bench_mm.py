"""Micro-benchmark: the statistics-pooling product in three number formats.

The counterpart of ``tools/bench_mm.py``. A dependent chain of ``REPS``
products ``acc = sum_r (x_r * x_r) @ pool`` with ``x [R, 2048]`` bfloat16,
``pool [2048, 128]`` and ``acc`` float32 ``[R, 128]``; after each rep
``x_{r+1} = bf16(x_r * bf16(MULT))``. Forms:

    f32   : float32 square, float32 x float32 product
    bf16  : x * x rounded to bf16, bf16 x bf16 product, float32 accumulate
    split : float32 square sq, hi = bf16(sq), lo = bf16(sq - hi),
            hi @ pool + lo @ pool in float32 (error-free against f32:
            the square of a bf16 value has at most 16 significant bits)

``bf16(0.999)`` is 1.0, so the chain's reps compute equal products; the
kernel takes the multiplier's bits as a runtime argument, so its compiler
cannot fold it and hoist the reps. :func:`mm_chain_apply` launches
``mm_chain_kernel`` (``csrc/microbench.cu``) for a CUDA tensor and runs
:func:`plain_chain` for a CPU one; the pool stays dense (the product is
what is timed), and any R is taken. Every form of the kernel runs on the
tensor cores: the f32 form as five exact bf16 products, of
:func:`split_square`'s hi / lo against :func:`split_pool`'s three parts of
the float32 pool (the wrapper splits it, inside the call).

    python -m graspldm_tpu_torch.tools.bench_mm [R_total] [--device cpu]
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ..cuda_build import KernelCounter, on_cuda, ptr
from ..utils.profiling import device_line, timeit
from ..flagship import resolve_device
from ..models.stacked_cuda import bf16_parts as split_pool  # the pool's exact bf16 split
from . import aligned, bf16_bits, tool_parser

__all__ = ["K", "N", "REPS", "MULT", "FORMS", "MM_CHAIN_KERNEL", "make_pool", "make_inputs",
           "split_square", "split_pool", "plain_chain", "mm_chain_apply", "bench", "line",
           "main"]

K, N = 2048, 128
REPS = 12
MULT = 0.999
FORMS = ("f32", "bf16", "split")
FORM_CODE = {f: i for i, f in enumerate(FORMS)}
MM_CHAIN_KERNEL = KernelCounter("mm_chain_kernel", "gl_mm_chain")


def make_pool(device=None):
    """The tool's pooling matrix: ``pool[i, (i // 32) % N] = 1/128``, as
    float32 and bf16 (1/128 is exact in both)."""
    pool = np.zeros((K, N), np.float32)
    for i in range(K):
        pool[i, (i // 32) % N] = 1.0 / 128.0
    pf = torch.from_numpy(pool).to(device)
    return pf, pf.to(torch.bfloat16)


def make_inputs(R: int, device=None, seed: int = 0) -> torch.Tensor:
    """``x [R, K]`` bf16 standard normals from a seeded generator on ``device``."""
    dev = torch.device(device or "cpu")
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((R, K), generator=gen, device=dev).to(torch.bfloat16)


def split_square(x: torch.Tensor):
    """``x * x`` of bf16 ``x`` (exact in float32: at most 16 significant
    bits) as two bf16 terms, ``hi + lo == x * x`` exactly: ``hi`` the
    square rounded to bf16, ``lo`` the rest."""
    sq = x.float() * x.float()
    hi = sq.to(torch.bfloat16)
    return hi, (sq - hi.float()).to(torch.bfloat16)


def plain_chain(x: torch.Tensor, pf: torch.Tensor, pb: torch.Tensor, form: str,
                reps: int = REPS) -> torch.Tensor:
    """The chain in plain PyTorch: float32 ``[R, N]``. A bf16 x bf16
    product with a float32 accumulate is a float32 product of the upcast
    operands (a product of two bf16 values is exact in float32)."""
    m = torch.tensor(MULT, dtype=torch.bfloat16, device=x.device)
    acc = None
    for _ in range(reps):
        if form == "f32":
            xf = x.float()
            s = (xf * xf) @ pf
        elif form == "bf16":
            s = (x * x).float() @ pb.float()
        elif form == "split":
            hi, lo = split_square(x)
            s = hi.float() @ pb.float() + lo.float() @ pb.float()
        else:
            raise ValueError(f"form must be one of {FORMS}, got {form!r}")
        acc = s if acc is None else acc + s
        x = x * m
    return acc


def mm_chain_apply(x: torch.Tensor, pf: torch.Tensor, pb: torch.Tensor, form: str,
                   reps: int = REPS) -> torch.Tensor:
    """The chain of ``x [R, K]`` (bf16) against ``pf`` / ``pb [K, 128]``
    (float32 / bf16): float32 ``[R, 128]``."""
    if form not in FORM_CODE:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    if x.ndim != 2 or x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bf16 [R, K], got {x.dtype} {tuple(x.shape)}")
    Kx = x.shape[1]
    if pf.shape != (Kx, N) or pb.shape != (Kx, N) or pf.dtype != torch.float32 \
            or pb.dtype != torch.bfloat16:
        raise ValueError(f"pf / pb must be float32 / bf16 [{Kx}, {N}], got {pf.dtype} "
                         f"{tuple(pf.shape)} / {pb.dtype} {tuple(pb.shape)}")
    if not on_cuda(x):
        return plain_chain(x, pf, pb, form, reps)
    if Kx % 32:
        raise ValueError(f"mm_chain_kernel takes K in steps of 32, got {Kx}")
    if pf.device != x.device or pb.device != x.device:
        raise ValueError("x, pf and pb must lie on one device")
    x, pool = aligned(x), aligned(split_pool(pf) if form == "f32" else pb)
    out = torch.empty((x.shape[0], N), dtype=torch.float32, device=x.device)
    MM_CHAIN_KERNEL(x, FORM_CODE[form], ptr(x), ptr(pool), ptr(out), x.shape[0], Kx, reps,
                    bf16_bits(MULT))
    return out


def bench(R_total: int = 8192, device=None, iters: int = 10, seed: int = 0) -> Iterator[dict]:
    """The tool's run: each form once for its result, then timed over
    ``iters`` calls after one warm-up (``iters + 2`` launches a form).
    Yields ``{"form", "seconds" (per product), "err", "out"}`` form by form,
    the error as the tool's, max |y - ref| / (|ref| + 1e-6) against the
    first form. The input is :func:`make_inputs` of ``seed``."""
    dev = resolve_device(device)
    x = make_inputs(R_total, dev, seed)
    pf, pb = make_pool(dev)
    ref = None
    for form in FORMS:
        y = mm_chain_apply(x, pf, pb, form)
        err = 0.0 if ref is None else float(((y - ref).abs() / (ref.abs() + 1e-6)).max())
        ref = y if ref is None else ref
        t = timeit(mm_chain_apply, x, pf, pb, form, iters=iters) / REPS
        yield dict(form=form, seconds=t, err=err, out=y)


def line(r: dict) -> str:
    """One form's printed line, as the JAX tool prints it."""
    return f"{r['form']:6s}: {r['seconds'] * 1e6:7.1f} us/matmul  max rel err vs f32={r['err']:.2e}"


def main(argv=None) -> None:
    a = tool_parser(__doc__).parse_args(argv)
    dev = resolve_device(a.device)
    print(device_line(dev), flush=True)
    for r in bench(a.R_total, dev, a.iters):
        print(line(r), flush=True)


if __name__ == "__main__":
    main()
