"""The one boundary between Python and the kernels: the C interface read from
``csrc/`` and the launch handles.

``cuda_build.c_entries`` reads each kernel source's ``extern "C"``
declarations into ctypes argtypes; ``load_library`` gives each entry those.
Each kernel's :class:`~graspldm_tpu_torch.cuda_build.KernelCounter` is the
one way Python launches it. These tests hold, on the CPU, that every handle
names an entry that ``csrc/`` declares, that every declared entry is
reached, that each wrapper's call matches its entry's declaration (against
a stand-in library), and what a handle does when the entry returns 0 and
when it does not.

This file imports torch only (no JAX) and needs no card.
"""

from __future__ import annotations

import ctypes
import types

import pytest
import torch

from graspldm_tpu_torch import cuda_build
from graspldm_tpu_torch.cuda_build import CSRC, c_entries, handles
from graspldm_tpu_torch.inference.pipeline import _denoiser_dims
from graspldm_tpu_torch.models import GraspLatentDDM
from graspldm_tpu_torch.models import cuda_sampler as cs
from graspldm_tpu_torch.models import stacked_cuda as sc
from graspldm_tpu_torch.models.stacked_denoiser import pack_math_weights
from graspldm_tpu_torch.ops import cuda_fps
from graspldm_tpu_torch.tools import bench_mm, bench_repeat, bench_silu

# the C entries that launch nothing
QUERIES = {"gl_fps_max_points"}
STREAM = 0x5EED


def _declared() -> dict:
    """Every entry of ``csrc/*.cu``: name -> (source, argtypes)."""
    out = {}
    for path in sorted(CSRC.glob("*.cu")):
        for name, argtypes in c_entries(path.read_text(), path.name).items():
            assert name not in out, f"{name} declared in {out[name][0]} and {path.name}"
            out[name] = (path.name, argtypes)
    return out


@pytest.mark.parametrize("name", sorted(handles()))
def test_handle_names_a_declared_entry(name):
    """Each handle's entry is declared in ``csrc/`` and takes the stream,
    a pointer, last."""
    handle = handles()[name]
    declared = _declared()
    assert handle.name == name
    assert handle.entry in declared, f"{name}: {handle.entry} is declared by no csrc/*.cu"
    assert declared[handle.entry][1][-1] is ctypes.c_void_p


def test_every_entry_is_reached_by_a_handle_or_is_a_query():
    entries = {h.entry for h in handles().values()}
    assert len(entries) == len(handles()), "two handles launch one entry"
    assert set(_declared()) == entries | QUERIES


def test_the_sources_are_the_build_list():
    """``load_library`` builds every ``csrc/*.cu`` and hashes every header,
    both in sorted order."""
    assert cuda_build._csrc(".cu") == sorted(p.name for p in CSRC.glob("*.cu"))
    assert cuda_build._csrc(".cuh") == sorted(p.name for p in CSRC.glob("*.cuh"))
    assert "kernels.cu" in cuda_build._csrc(".cu")
    assert "tc_blocks.cuh" in cuda_build._csrc(".cuh")


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("param,ctype", [
    ("const float* x", ctypes.c_void_p),
    ("void* stream", ctypes.c_void_p),
    ("const long long* net", ctypes.c_void_p),
    ("unsigned long long* out", ctypes.c_void_p),
    ("int BG", ctypes.c_int),
    ("float clip_range", ctypes.c_float),
    ("long long n", ctypes.c_longlong),
    ("const int n", ctypes.c_int),
])
def test_reader_maps_each_c_type(param, ctype):
    text = f'extern "C" int gl_one({param}, void* stream) {{ return 0; }}'
    assert c_entries(text, "one.cu") == {"gl_one": [ctype, ctypes.c_void_p]}


@pytest.mark.parametrize("param", ["double x", "unsigned n", "size_t n", "bool flag",
                                   "cudaStream_t st"])
def test_reader_refuses_an_unknown_type(param):
    text = f'extern "C" int gl_bad(int a, {param}) {{ return 0; }}'
    with pytest.raises(TypeError, match=rf"bad\.cu: gl_bad: parameter '{param}'"):
        c_entries(text, "bad.cu")


def test_reader_reads_blocks_and_single_declarations_only():
    """Entries in an ``extern "C"`` block and single ``extern "C"``
    declarations; nothing outside them, nothing in comments, no parameter
    for ``()`` or ``(void)``."""
    text = """
int gl_outside(int a) { return a; }
// extern "C" int gl_commented(int a) { return a; }
/* extern "C" { int gl_block_commented(float a) { return 0; } } */
extern "C" int gl_query() { return 4; }
extern "C" int gl_void(void) { return 0; }
extern "C" {

// a comment with braces { }
int gl_first(const void* x, int n, void* stream) {
  if (n) { return 1; }
  return 0;
}

int gl_second(float a, long long b, void* stream) { return 0; }

}  // extern "C"
int gl_after(int a) { return a; }
"""
    P = ctypes.c_void_p
    assert c_entries(text, "t.cu") == {
        "gl_query": [], "gl_void": [],
        "gl_first": [P, ctypes.c_int, P],
        "gl_second": [ctypes.c_float, ctypes.c_longlong, P],
    }


# ---------------------------------------------------------------------------
# the handle, against a stand-in library
# ---------------------------------------------------------------------------


class _Library:
    """Stands in for ``load_library()``'s namespace: each entry records its
    arguments and returns ``rc`` (queries return ``value``)."""

    def __init__(self, rc: int = 0, value: int = 4096):
        self.rc, self.value, self.calls = rc, value, []

    def __getattr__(self, entry: str):
        if entry.startswith("__"):
            raise AttributeError(entry)

        def fn(*args):
            if entry in QUERIES:
                return self.value
            self.calls.append((entry, args))
            return self.rc
        return fn


@pytest.fixture
def library(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(cuda_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=STREAM))
    return lib


def test_handle_launches_counts_and_passes_the_stream_last(library):
    before = sc.FULL_KERNEL.launches
    x = torch.zeros(2)
    assert sc.FULL_KERNEL(x, 1, ctypes.c_void_p(8), 3) is None
    assert sc.FULL_KERNEL.launches == before + 1
    (entry, args), = library.calls
    assert entry == "gl_full_forward"
    assert args[0] == 1 and args[1].value == 8 and args[2] == 3
    assert isinstance(args[-1], ctypes.c_void_p) and args[-1].value == STREAM


@pytest.mark.parametrize("rc", [1, 700])
def test_handle_raises_naming_the_kernel_and_counts_nothing(library, rc):
    library.rc = rc
    before = cs.CHURN_KERNEL.launches
    with pytest.raises(RuntimeError, match=rf"churn_sampler_kernel launch failed: cudaError {rc}"):
        cs.CHURN_KERNEL(torch.zeros(2), 1)
    assert cs.CHURN_KERNEL.launches == before
    assert [e for e, _ in library.calls] == ["gl_churn_sample"]


def test_handle_looks_its_entry_up_at_each_call(library):
    """A tool may swap another build's function into the namespace between
    calls; the handle takes whatever is there."""
    seen = []
    library.gl_ddim_sample = lambda *args: seen.append(args) or 0
    cs.SAMPLER_KERNEL(torch.zeros(2), 5)
    assert len(seen) == 1 and seen[0][0] == 5 and library.calls == []


# ---------------------------------------------------------------------------
# each wrapper's call against its entry's declaration
# ---------------------------------------------------------------------------


def _net(dtype=torch.float32) -> sc.PackedNet:
    torch.manual_seed(0)
    ddm = GraspLatentDDM(block_channels=(32, 64), dropout=None, latent_in_features=4,
                         pc_latent_size=64).eval()
    dims = _denoiser_dims(ddm)
    return sc.PackedNet(pack_math_weights(ddm, dims), dims, dtype, "cpu")


def _calls():
    """handle name -> a call of its wrapper on CPU operands of the right
    shapes (run with ``on_cuda`` patched true)."""
    w = _net()
    d = w.dims
    BG, L, S, CeE = 3, d.seq_len, 2, d.cond_channels * d.emb_dim
    f = torch.zeros

    def film(cols):
        return f(BG, cols), f(BG, CeE)

    x_T, embin, trows, coefs = f(BG, L), f(BG, CeE), f(S, CeE), f(S, 8)
    noise = f(S, BG, L)
    n = len(d.block_channels)
    pf, pb = bench_mm.make_pool()
    return {
        "stage_kernel": lambda: sc.stage_apply(w, 1, *film(L * d.cins[1])),
        "stage_kernel_cuda_cores": lambda: sc.stage_apply(w, 0, *film(L * d.cins[0]),
                                                          cuda_cores=True),
        "final_kernel": lambda: sc.final_apply(w, *film(L * d.block_channels[-1])),
        "final_kernel_cuda_cores": lambda: sc.final_apply(w, *film(L * d.block_channels[-1]),
                                                          cuda_cores=True),
        "full_kernel": lambda: sc.full_apply(w, *film(L * w.w["init_w"].shape[1])),
        "hybrid_stage_kernel": lambda: sc.hybrid_stage_apply(w, 1, *film(L * d.cins[0])),
        "hybrid_final_kernel": lambda: sc.hybrid_final_apply(w, *film(L * d.cins[n - 1])),
        "ddim_sampler_kernel": lambda: cs.sampler_apply(w, x_T, embin, trows, coefs, noise),
        "ddim_step_kernel": lambda: cs.ddim_step_apply(w, x_T, embin, trows[0], coefs[0]),
        "dpmpp_sampler_kernel": lambda: cs.dpmpp_sampler_apply(w, x_T, embin, trows, coefs),
        "dpmpp_step_kernel": lambda: cs.dpmpp_step_apply(w, x_T, f(BG, L), embin, trows[0],
                                                         coefs[0]),
        "churn_sampler_kernel": lambda: cs.churn_sampler_apply(w, x_T, embin, trows, trows,
                                                               coefs, coefs, noise),
        "churn_step_kernel": lambda: cs.churn_step_apply(w, x_T, embin, trows[0], trows[0],
                                                         coefs[0], coefs[0], noise[0]),
        "fps_kernel": lambda: cuda_fps.fps_apply(f(2, 16, 3), 4),
        "mm_chain_kernel": lambda: bench_mm.mm_chain_apply(
            bench_mm.make_inputs(2), pf, pb, "f32"),
        "silu_chain_kernel": lambda: bench_silu.silu_chain_apply(
            bench_silu.make_inputs(2, 64), "bf16exp"),
        "bcast_chain_kernel": lambda: bench_repeat.bcast_chain_apply(
            *bench_repeat.make_inputs(2), bench_repeat.qbcast(), "narrow"),
    }


def _kind_ok(value, ctype) -> bool:
    if ctype is ctypes.c_void_p:
        return value is None or isinstance(value, ctypes.c_void_p)
    if ctype is ctypes.c_float:
        return isinstance(value, float)
    return isinstance(value, int) and not isinstance(value, bool)


@pytest.mark.parametrize("name", sorted(handles()))
def test_wrapper_call_matches_the_declaration(name, library, monkeypatch):
    """Each wrapper passes its entry as many arguments as the C declaration
    has parameters, each of the declared kind (a pointer as ``c_void_p`` or
    None, ``int`` / ``long long`` as an int, ``float`` as a float), the
    stream last; one launch counted."""
    for module in (sc, cs, cuda_fps, bench_mm, bench_silu, bench_repeat):
        monkeypatch.setattr(module, "on_cuda", lambda t: True)
    handle = handles()[name]
    before = handle.launches
    _calls()[name]()
    (entry, args), = library.calls
    assert entry == handle.entry
    argtypes = _declared()[entry][1]
    assert len(args) == len(argtypes), f"{name}: {len(args)} arguments, {entry} takes " \
                                       f"{len(argtypes)}"
    bad = [i for i, (a, t) in enumerate(zip(args, argtypes)) if not _kind_ok(a, t)]
    assert not bad, f"{name}: arguments {bad} are not of {entry}'s declared kinds"
    assert args[-1].value == STREAM
    assert handle.launches == before + 1
