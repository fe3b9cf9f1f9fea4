"""Build and load the Hopper kernels (``csrc/``) at first use.

``nvcc`` compiles ``csrc/kernels.cu`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so the
build takes seconds). The library lands in ``graspldm_tpu_torch/build/``
(git-ignored), named by a hash of the sources, so an edited source is
rebuilt and an unchanged one is reused. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["load_library", "nvcc_path", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
_SOURCES = ("kernels.cu", "resnet1d_blocks.cuh")
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "-lineinfo",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # dtype, x, emb, w, rec, out, BG, L, C, Cout, E, Ce, G, stream
    "gl_stage_forward": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # dtype, x, emb, w, rec, out, BG, L, C, E, Ce, G, stream
    "gl_final_forward": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # dtype, xT, embin, trows, coefs, noise, w, net, out, BG, S, L, E, Ce, G,
    # cmax, clip, clip_range, stream
    "gl_ddim_sample": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _I, _I, ctypes.c_float, _P],
}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest() -> str:
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; raises on failure."""
    so = BUILD_DIR / f"libgraspldm_kernels_{_digest()}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *_FLAGS, "-o", tmp, str(CSRC / "kernels.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        (BUILD_DIR / "nvcc.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
