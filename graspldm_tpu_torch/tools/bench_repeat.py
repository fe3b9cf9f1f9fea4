"""Micro-benchmark: the attention's per-(l, h) score broadcast.

The counterpart of ``tools/bench_repeat.py``. L = 16, H = 4, D = 32,
hd = H * D = 128; ``s [R, L*H]`` and ``v [R, L*hd]`` bfloat16. Each of
``REPS`` reps computes, in bf16,

    acc[:, h*D + d] = reduce(add, [bf16(s[:, l*H + h] * v[:, l*hd + h*D + d])
                                   for l in range(L)])

(a left fold, ``functools.reduce``'s order, each sum rounded), then
``s = bf16(s * DECAY) + bf16(acc[:, :L*H] * ZERO)`` (both bf16: 0.5 and
0.0); the output is the last rep's ``acc``, bf16 ``[R, hd]``. The forms
differ in how the broadcast of ``s`` to ``[R, L*hd]`` is formed, and give
equal bits:

    matmul : the product with the one-hot [L*H, L*hd] matrix (qbcast)
    repeat : a lane broadcast (jnp.repeat / repeat_interleave)
    narrow : one slice product per l

:func:`bcast_chain_apply` launches ``bcast_chain_kernel``
(``csrc/microbench.cu``) for a CUDA tensor and runs :func:`plain_chain` for
a CPU one; the decay and the zero are runtime arguments of the kernel.

    python -m graspldm_tpu_torch.tools.bench_repeat [R_total] [--device cpu]
"""

from __future__ import annotations

import functools
from typing import Iterator

import torch

from ..cuda_build import KernelCounter, on_cuda, ptr
from ..utils.profiling import device_line, timeit
from ..flagship import resolve_device
from . import aligned, bf16_bits, tool_parser

__all__ = ["L", "H", "D", "HD", "REPS", "FORMS", "BCAST_CHAIN_KERNEL", "qbcast", "make_inputs",
           "plain_chain", "bcast_chain_apply", "bench", "line", "main"]

L, H, D = 16, 4, 32
HD = H * D
REPS = 20
DECAY, ZERO = 0.5, 0.0
FORMS = ("matmul", "repeat", "narrow")
FORM_CODE = {f: i for i, f in enumerate(FORMS)}
BCAST_CHAIN_KERNEL = KernelCounter("bcast_chain_kernel", "gl_bcast_chain")


def qbcast(device=None) -> torch.Tensor:
    """The one-hot broadcast matrix, bf16 ``[L*H, L*hd]``: row l*H + h is 1
    on columns l*hd + h*D ... l*hd + (h+1)*D - 1."""
    b = torch.zeros((L * H, L * HD), dtype=torch.bfloat16, device=device)
    for l in range(L):
        for h in range(H):
            b[l * H + h, l * HD + h * D: l * HD + (h + 1) * D] = 1.0
    return b


def make_inputs(R: int, device=None, seed: int = 0):
    """``s [R, L*H]`` and ``v [R, L*hd]``, bf16 standard normals from a
    seeded generator on ``device``."""
    dev = torch.device(device or "cpu")
    gen = torch.Generator(device=dev).manual_seed(seed)
    s = torch.randn((R, L * H), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((R, L * HD), generator=gen, device=dev).to(torch.bfloat16)
    return s, v


def _fold(parts):
    return functools.reduce(torch.add, parts)


def plain_chain(s: torch.Tensor, v: torch.Tensor, b: torch.Tensor, form: str,
                reps: int = REPS) -> torch.Tensor:
    """The chain in plain PyTorch: bf16 ``[R, hd]``. The one-hot product is
    exact in float32 and rounds back to ``s``."""
    half = torch.tensor(DECAY, dtype=torch.bfloat16, device=s.device)
    nil = torch.tensor(ZERO, dtype=torch.bfloat16, device=s.device)
    acc = None
    for _ in range(reps):
        if form == "narrow":
            acc = _fold([s[:, m * H:(m + 1) * H].repeat_interleave(D, dim=1)
                         * v[:, m * HD:(m + 1) * HD] for m in range(L)])
        else:
            if form == "matmul":
                sb = (s.float() @ b.float()).to(torch.bfloat16)
            elif form == "repeat":
                sb = s.repeat_interleave(D, dim=1)
            else:
                raise ValueError(f"form must be one of {FORMS}, got {form!r}")
            term = sb * v
            acc = _fold([term[:, m * HD:(m + 1) * HD] for m in range(L)])
        s = s * half + acc[:, :L * H] * nil
    return acc


def bcast_chain_apply(s: torch.Tensor, v: torch.Tensor, b: torch.Tensor, form: str,
                      reps: int = REPS) -> torch.Tensor:
    """The chain of ``s [R, L*H]``, ``v [R, L*hd]`` and the one-hot ``b``
    (all bf16): bf16 ``[R, hd]``."""
    if form not in FORM_CODE:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    R = s.shape[0]
    for name, t, shape in (("s", s, (R, L * H)), ("v", v, (R, L * HD)), ("b", b, (L * H, L * HD))):
        if t.dtype != torch.bfloat16 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be bf16 {list(shape)}, got {t.dtype} {tuple(t.shape)}")
    if not on_cuda(s):
        return plain_chain(s, v, b, form, reps)
    if v.device != s.device or b.device != s.device:
        raise ValueError("s, v and b must lie on one device")
    s, v, b = aligned(s), aligned(v), aligned(b)
    out = torch.empty((R, HD), dtype=torch.bfloat16, device=s.device)
    BCAST_CHAIN_KERNEL(s, FORM_CODE[form], ptr(s), ptr(v), ptr(b), ptr(out), R, reps,
                       bf16_bits(DECAY), bf16_bits(ZERO))
    return out


def bench(R_total: int = 8192, device=None, iters: int = 10, seed: int = 0) -> Iterator[dict]:
    """The tool's run: each form once for its result, then timed over
    ``iters`` calls after one warm-up (``iters + 2`` launches a form).
    Yields ``{"form", "seconds" (per apply), "err", "out"}`` form by form,
    the error max |y - ref| against the first form. The inputs are
    :func:`make_inputs` of ``seed``."""
    dev = resolve_device(device)
    (s, v), b = make_inputs(R_total, dev, seed), qbcast(dev)
    ref = None
    for form in FORMS:
        y = bcast_chain_apply(s, v, b, form)
        err = 0.0 if ref is None else float((y.float() - ref.float()).abs().max())
        ref = y if ref is None else ref
        t = timeit(bcast_chain_apply, s, v, b, form, iters=iters) / REPS
        yield dict(form=form, seconds=t, err=err, out=y)


def line(r: dict) -> str:
    """One form's printed line, as the JAX tool prints it, with the error
    against the first form beside it."""
    return (f"{r['form']:7s}: {r['seconds'] * 1e6:8.1f} us/apply (R={r['out'].shape[0]})  "
            f"max|err vs matmul|={r['err']:.2e}")


def main(argv=None) -> None:
    a = tool_parser(__doc__).parse_args(argv)
    dev = resolve_device(a.device)
    print(device_line(dev), flush=True)
    for r in bench(a.R_total, dev, a.iters):
        print(line(r), flush=True)


if __name__ == "__main__":
    main()
