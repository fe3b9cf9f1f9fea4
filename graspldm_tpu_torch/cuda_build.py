"""Build and load the Hopper kernels (``csrc/``) at first use.

``nvcc`` compiles each kernel source in ``csrc/`` for ``sm_90a`` into a
shared library of its own with a plain C interface, loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). The sources build in
parallel, one ``nvcc`` each, all started together. The libraries land in
``graspldm_tpu_torch/build/`` (git-ignored), each named by a hash of its
source, the shared headers and the flags, so an edited source is rebuilt
and an unchanged one is reused. A process that builds says so on standard
error: how many libraries it built, in how many seconds, and how many it
reused (a build adds about a minute to the first call). Nothing here runs
at import time.

The wrappers' shared pieces live here too: :class:`KernelCounter` (each
wrapper adds one per launch), :func:`on_cuda` (which side of the wrapper a
tensor takes) and :func:`check_launch`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

__all__ = ["load_library", "library_path", "nvcc_path", "BUILD_DIR", "KernelCounter", "on_cuda",
           "check_launch"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
_HEADERS = ("resnet1d_blocks.cuh", "sampler_body.cuh", "tc_blocks.cuh")
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "-lineinfo",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
# source -> {C entry: argtypes}
_SOURCES = {
    "kernels.cu": {
        # dtype, x, emb, w, net, stage, out, BG, L, C, Cout, E, Ce, G, stream
        "gl_stage_forward": [_I, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        # dtype, x, emb, w, net, n_st, out, BG, L, C, E, Ce, G, stream
        "gl_final_forward": [_I, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P],
        # the float32 CUDA-core control of the two: the same without dtype
        "gl_stage_forward_cuda_cores": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        "gl_final_forward_cuda_cores": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P],
        # dtype, xT, embin, trows, coefs, noise, w, net, out, BG, S, L, E, Ce, G,
        # cmax, clip, clip_range, stream
        "gl_ddim_sample": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _I, ctypes.c_float, _P],
    },
    "dpmpp_sampler.cu": {
        # dtype, xT, embin, trows, coefs, w, net, out, BG, S, L, E, Ce, G, cmax,
        # clamp, stream
        "gl_dpmpp_sample": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _P],
    },
    "churn_sampler.cu": {
        # dtype, xT, embin, trowsA, trowsB, coefA, coefB, noise, w, net, out, BG, S,
        # L, E, Ce, G, cmax, clamp, stream
        "gl_churn_sample": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _I, _P],
    },
    "full_net.cu": {
        # dtype, x, emb, w, net, out, BG, L, E, Ce, G, cmax, stream
        "gl_full_forward": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    },
    "hybrid.cu": {
        # dtype, x, emb, w, net, stage, out, BG, L, Cin, C, E, Ce, G, stream
        "gl_hybrid_stage_forward": [_I, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        "gl_hybrid_final_forward": [_I, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    },
    "fps.cu": {
        # coords, out, B, N, M, stream
        "gl_fps": [_P, _P, _I, _I, _I, _P],
        "gl_fps_max_points": [],
    },
    "microbench.cu": {
        # form, x, pool, out, R, K, reps, mult_bits, stream
        "gl_mm_chain": [_I, _P, _P, _P, _I, _I, _I, _I, _P],
        # form, x, out, n, reps, mult_bits, stream
        "gl_silu_chain": [_I, _P, _P, ctypes.c_longlong, _I, _I, _P],
        # form, s, v, onehot, out, R, reps, half_bits, zero_bits, stream
        "gl_bcast_chain": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "step_samplers.cu": {
        # dtype, x, embin, trow, coef, noise, w, net, out, BG, L, E, Ce, G, cmax, clip,
        # clip_range, stream
        "gl_ddim_step": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         ctypes.c_float, _P],
        # dtype, x, old, embin, trow, coef, w, net, x_new, den, BG, L, E, Ce, G, cmax,
        # clamp, stream
        "gl_dpmpp_step": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _I, _P],
        # dtype, x, noise, embin, trowA, trowB, coefA, coefB, w, net, out, BG, L, E, Ce,
        # G, cmax, clamp, stream
        "gl_churn_step": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _P],
    },
}


class KernelCounter:
    """Launch count of one kernel: its wrapper adds one per launch."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def __repr__(self) -> str:
        return f"KernelCounter({self.name!r}, launches={self.launches})"


def on_cuda(x) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (run
    the plain version); any other device is refused."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return True


def check_launch(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {rc}")


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest(source: str) -> str:
    h = hashlib.sha256()
    for name in (source, *_HEADERS):
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(source: str) -> Path:
    """Where the library built from ``source`` lives (named by its digest)."""
    return BUILD_DIR / f"lib{Path(source).stem}_{_digest(source)}.so"


@functools.lru_cache(maxsize=None)
def load_library() -> types.SimpleNamespace:
    """Compile (if needed) and load every kernel library; raises on failure.

    Returns a namespace of the C entries of all of them (``gl_*``)."""
    todo = [src for src in _SOURCES if not library_path(src).exists()]
    if todo:
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        jobs = []
        for src in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *_FLAGS, "-o", tmp, str(CSRC / src)]
            jobs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        errors, log = [], []
        for src, tmp, proc in jobs:
            out, err = proc.communicate()
            log.append(f"== {src} (rc {proc.returncode})\n{out}{err}")
            if proc.returncode != 0:
                os.unlink(tmp)
                errors.append(f"nvcc failed on {src} ({proc.returncode}):\n{err[-4000:]}")
            else:
                os.replace(tmp, library_path(src))
        (BUILD_DIR / "nvcc.log").write_text("\n".join(log))
        if errors:
            raise RuntimeError("\n".join(errors))
        print(f"graspldm_tpu_torch: built {len(todo)} kernel libraries with nvcc in "
              f"{time.perf_counter() - t0:.1f} s, reused {len(_SOURCES) - len(todo)}",
              file=sys.stderr, flush=True)
    fns = {}
    for src, entries in _SOURCES.items():
        lib = ctypes.CDLL(str(library_path(src)))
        for name, argtypes in entries.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
    return types.SimpleNamespace(**fns)
