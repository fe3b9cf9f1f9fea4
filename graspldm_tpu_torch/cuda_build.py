"""Build and load the Hopper kernels (``csrc/``) at first use, and launch them.

``nvcc`` compiles each kernel source ``csrc/*.cu`` for ``sm_90a`` into a
shared library of its own with a plain C interface, loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). The sources build in
parallel, one ``nvcc`` each, all started together. The libraries land in
``graspldm_tpu_torch/build/`` (git-ignored), each named by a hash of its
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source is rebuilt and an unchanged one is reused. A process that builds
says so on standard error: how many libraries it built, in how many
seconds, and how many it reused (a build adds about a minute to the first
call). Nothing here runs at import time.

The C interface lives in the sources alone: each library's entries are the
``int gl_...(...)`` functions its source declares in ``extern "C"``, and
their argument types are read from those declarations (:func:`c_entries`).

Python launches a kernel only through its :class:`KernelCounter`, the
kernel's one handle: it names the C entry, launches it on the current
stream, raises if the launch fails and counts it. :data:`HANDLES` holds
every handle by kernel name (:func:`handles`: all of them). :func:`on_cuda`
says which side of a wrapper a tensor takes; :func:`ptr` and
:func:`check_operand` are the wrappers' operand helpers.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import importlib
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path
from typing import Dict, List, Optional

import torch

__all__ = ["load_library", "library_path", "nvcc_path", "c_entries", "query", "BUILD_DIR",
           "KernelCounter", "HANDLES", "handles", "on_cuda", "ptr", "check_operand"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "-lineinfo",
]
# the C parameter types an entry may take, besides pointers (c_void_p)
_CTYPES = {"int": ctypes.c_int, "float": ctypes.c_float, "long long": ctypes.c_longlong}
_ENTRY = re.compile(r"\bint\s+(gl_\w+)\s*\(([^)]*)\)\s*\{")


def _csrc(suffix: str) -> List[str]:
    return sorted(p.name for p in CSRC.glob("*" + suffix))


def c_entries(text: str, source: str) -> Dict[str, list]:
    """The C entries of a kernel source's text: each ``int gl_...(...)``
    function it declares in ``extern "C"`` (a block or a single
    declaration), name -> ctypes argtypes. A pointer is ``c_void_p``;
    ``int``, ``float`` and ``long long`` are their ctypes types; any other
    parameter type raises ``TypeError`` naming ``source`` and the parameter."""
    text = re.sub(r"//[^\n]*|/\*.*?\*/", "", text, flags=re.S)
    entries = {}
    for m in re.finditer(r'extern\s+"C"\s*(\{)?', text):
        end = m.end() if m.group(1) else text.index("{", m.end()) + 1
        depth = 1 if m.group(1) else 0
        while depth:  # to the block's closing brace
            depth += {"{": 1, "}": -1}.get(text[end], 0)
            end += 1
        for e in _ENTRY.finditer(text[m.end():end]):
            argtypes = []
            for param in filter(None, (p.strip() for p in e.group(2).split(","))):
                kind = " ".join(w for w in param.split()[:-1] if w != "const")
                if "*" in param:
                    argtypes.append(ctypes.c_void_p)
                elif kind in _CTYPES:
                    argtypes.append(_CTYPES[kind])
                elif param != "void":
                    raise TypeError(f"{source}: {e.group(1)}: parameter {param!r} has a C type "
                                    f"the loader does not map (pointers, {', '.join(_CTYPES)})")
            entries[e.group(1)] = argtypes
    return entries


HANDLES: Dict[str, "KernelCounter"] = {}
# the modules that define the handles
_KERNEL_MODULES = ("models.stacked_cuda", "models.cuda_sampler", "ops.cuda_fps",
                   "tools.bench_mm", "tools.bench_silu", "tools.bench_repeat")


class KernelCounter:
    """One kernel's launch handle: the C entry that launches it and its
    launch count.

    ``handle(t, *args)`` loads the libraries, calls ``entry`` with ``args``
    and the current stream of ``t``'s device appended, raises
    ``RuntimeError`` naming the kernel if the entry returns non-zero, and
    counts one launch. The entry is looked up at each call, so a tool may
    swap another build's function into :func:`load_library`'s namespace.
    Each handle registers itself in :data:`HANDLES` by kernel name."""

    def __init__(self, name: str, entry: str):
        self.name, self.entry = name, entry
        self.launches = 0
        HANDLES[name] = self

    def __call__(self, t: torch.Tensor, *args) -> None:
        stream = ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
        rc = getattr(load_library(), self.entry)(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError {rc}")
        self.launches += 1

    def __repr__(self) -> str:
        return f"KernelCounter({self.name!r}, {self.entry!r}, launches={self.launches})"


def handles() -> Dict[str, KernelCounter]:
    """Every kernel's handle by name (:data:`HANDLES`, with the modules that
    define them imported)."""
    for module in _KERNEL_MODULES:
        importlib.import_module(f"{__package__}.{module}")
    return HANDLES


def query(entry: str) -> int:
    """The value of a C entry that launches nothing (``gl_fps_max_points``)."""
    return getattr(load_library(), entry)()


def on_cuda(x) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (run
    the plain version); any other device is refused."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return True


def ptr(t: Optional[torch.Tensor]) -> Optional[ctypes.c_void_p]:
    """A tensor's data pointer as a C argument (None for a missing operand)."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def check_operand(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on ``device``."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, weights on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


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
    for name in (source, *_csrc(".cuh")):
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(source: str) -> Path:
    """Where the library built from ``source`` lives (named by its digest)."""
    return BUILD_DIR / f"lib{Path(source).stem}_{_digest(source)}.so"


@functools.lru_cache(maxsize=None)
def load_library() -> types.SimpleNamespace:
    """Compile (if needed) and load every kernel library; raises on failure.

    Returns a namespace of the C entries of all of them (``gl_*``), each
    with the argtypes of its declaration (:func:`c_entries`)."""
    sources = _csrc(".cu")
    todo = [src for src in sources if not library_path(src).exists()]
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
              f"{time.perf_counter() - t0:.1f} s, reused {len(sources) - len(todo)}",
              file=sys.stderr, flush=True)
    fns = {}
    for src in sources:
        lib = ctypes.CDLL(str(library_path(src)))
        for name, argtypes in c_entries((CSRC / src).read_text(), src).items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
    return types.SimpleNamespace(**fns)
