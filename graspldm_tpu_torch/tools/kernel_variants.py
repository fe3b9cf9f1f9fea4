"""Design check of the tensor-core network bodies on one card: each decision
of their design against the kernel sources without it.

A variant is ``csrc/`` with text patches that undo one decision (every patch
must apply once, or the run stops before it builds). Each variant's
libraries of the timed kernels build side by side, one ``nvcc`` a source,
all started together, into the git-ignored build directory. Then each
timed call runs with every variant's entry in turn, forward and back, on
the same operands (seeded weights of the fpc / ppc flagship denoisers and
the VAE decoder), and the line prints each variant's lesser ms of its two
turns and, for ``full_kernel``, its error against ``full_plain`` relative
to max(1, max|ref|), beside the float32 stage chain's CUDA-core control's
(``cuda_cores=True``).
``--kernels`` limits the timed calls (and the sources built) to some of
``full``, ``ddim``, ``stage``, ``final``, ``churn`` and ``dpmpp``. Each
nvcc's ``-Xptxas -v`` report gives every built kernel's registers and
spills, a line each.

The churn lines give, beside each variant's time, a mean error relative to
max(1, max|ref|) that ``chip_smoke.py`` holds in bf16: of a 2-step
trajectory against ``churn_sampler_plain`` (``TOL_BF16_EDM_STEP_MEAN``),
and of the first 3 churn steps against ``churn_step_plain``
(``TOL_BF16_STEP_MEAN["churn"]``). The DDIM lines time
``ddim_sampler_kernel`` (100 steps) and one ``ddim_step_kernel`` launch
(step 50 of 100) in both dtypes at the fpc and ppc denoisers, on the
operands of ``chip_smoke.py``'s step-kernel phase (its seed, rows and
schedule), and give each variant's largest error of the float32 sampler
against ``sampler_plain`` and its mean error over the first 3 chained
DDIM steps against ``ddim_step_plain`` (the largest over the 3 states, at
the full BG and at the ragged 1021), which chip_smoke.py holds in bf16
(``TOL_BF16_STEP_MEAN["ddim"]``). The DPM++ lines time
``dpmpp_sampler_kernel`` (32 steps) in both dtypes at the fpc and ppc
denoisers, with the float32 kernel's largest error against
``dpmpp_sampler_plain`` and the bf16 kernel's mean error over a 2-step
trajectory (``TOL_BF16_EDM_STEP_MEAN``). The decoder lines time a
decode's 4 ``stage_kernel`` launches (BG = 4096) and ``final_kernel`` (BG =
4096 and 1021) at the VAE decoder in both dtypes, with the largest error
against ``stage_plain`` / ``final_plain`` (the stages' in float32 only),
in float32 beside the CUDA-core control's error and time.

``--parent DIR`` builds another tree's ``csrc`` (the parent commit's, say)
as the variant ``parent``: it is timed beside the others, and each
variant's outputs of the tensor-core kernels at the flagships' shapes and
of the float32 CUDA-core control are held bitwise against its own
(``bitwise``): "as built", "GroupNorm in two passes" (the statistics
and the apply apart again) and "bf16 GroupNorm in one pass" must all be,
as the one pass keeps group_stats' order.

``--staging`` builds the sources of the float32 tensor-core sampler kernels
(the DPM++ sampler, the churn pair, the DDIM pair) and of the decoder's
``stage_kernel`` and ``final_kernel`` once more with a counter of the path each
tensor-core product of block 0 takes (its A staged in the dead buffers;
read value by value for a width off the 16-wide k-step; or value by value
for want of room, which must read 0) and of block 0's resblocks by how they
run GroupNorm (one pass or two: every float32 resblock must take one, a
bf16 one two) and prints the counts of one launch of
each at the fpc and ppc denoisers (the decoder's: at the decoder, the
stages in float32, the final block in both dtypes).

    python -m graspldm_tpu_torch.tools.kernel_variants [VARIANT ...] [--kernels K ...]
        [--staging] [--parent DIR]

(the variants first: ``--kernels`` takes every name after it).

Needs a card and ``nvcc``; it raises without them.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import types
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch

from ..cuda_build import _FLAGS, _SOURCES, BUILD_DIR, CSRC, load_library, nvcc_path
from ..flagship import FlagshipConfig, build_flagship, resolve_device
from ..inference.pipeline import _denoiser_dims
from ..models import cuda_sampler as cs
from ..models import stacked_cuda as sc
from ..models.fast_decoder import decoder_dims_for
from ..models.stacked_denoiser import (
    compute_emb_s_stacked, compute_input_emb, pack_math_weights,
)
from ..utils.profiling import device_line, timeit

__all__ = ["VARIANTS", "patched_sources", "main"]

_TC, _SB, _K, _RB = "tc_blocks.cuh", "sampler_body.cuh", "kernels.cu", "resnet1d_blocks.cuh"
_BF16_CHURN_TC = (_SB, "template <typename T> constexpr bool kChurnTc = sizeof(T) == 4;",
                  "template <typename T> constexpr bool kChurnTc = true;")
# each bf16 mma into a zeroed accumulator, its sum added to the running one
# with a float32 add: no truncated running sum
_FRESH = (_TC, """            mma_bf16(acc[i][2 * q], a[0], bq[d][0][q].x, bq[d][0][q].y);
            mma_bf16(acc[i][2 * q + 1], a[0], bq[d][0][q].z, bq[d][0][q].w);
""", """            if constexpr (NA == 1) {
              float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
              mma_bf16(t0, a[0], bq[d][0][q].x, bq[d][0][q].y);
              mma_bf16(t1, a[0], bq[d][0][q].z, bq[d][0][q].w);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                acc[i][2 * q][e] += t0[e];
                acc[i][2 * q + 1][e] += t1[e];
              }
            } else {
              mma_bf16(acc[i][2 * q], a[0], bq[d][0][q].x, bq[d][0][q].y);
              mma_bf16(acc[i][2 * q + 1], a[0], bq[d][0][q].z, bq[d][0][q].w);
            }
""")
# the float32 tensor-core resblocks' GroupNorms back in two passes each,
# group_stats and then the apply (resblock's own code): the same outputs
# bit for bit, as the one pass keeps group_stats' order
_GN_TWO_PASSES = [
    (_RB, "  if constexpr (P::kGn) {  // each GroupNorm one pass\n", "  if constexpr (false) {\n"),
]
# gn_pass's three loops not unrolled: each read waits on the one before
_GN_ROLLED = [
    (_RB, "#pragma unroll 4\n    for (int i = lane; i < n; i += 32) s += ",
     "    for (int i = lane; i < n; i += 32) s += "),
    (_RB, "#pragma unroll 4\n    for (int i = lane; i < n; i += 32) {\n      const float d",
     "    for (int i = lane; i < n; i += 32) {\n      const float d"),
    (_RB, "#pragma unroll 4\n    for (int i = lane + 32 * part; i < n; i += 32 * split) {",
     "    for (int i = lane + 32 * part; i < n; i += 32 * split) {"),
]
# a pair a warp, the others idle where there are more warps than pairs
_GN_PAIR_A_WARP = [
    (_RB, "  const int split = nw >= 2 * pairs ? nw / pairs : 1;",
     "  const int split = 1;"),
]
# name -> [(file, text, replacement)]: each undoes one decision
VARIANTS: Dict[str, List[Tuple[str, str, str]]] = {
    "as built": [],
    "GroupNorm in two passes": _GN_TWO_PASSES,
    "GroupNorm pass loops rolled": _GN_ROLLED,
    "GroupNorm pass a warp a pair": _GN_PAIR_A_WARP,
    "bf16 GroupNorm in one pass": [
        (_TC, "  static constexpr bool kGn = sizeof(T) == 4;", "  static constexpr bool kGn = true;")],
    "fp32 fpc at 9 rows": [(_SB, "  if (R * L > 32) R -= (R * L % 32) / L;\n", "")],
    "bf16: B 1 k-step ahead": [(_TC, "constexpr int kTcDepth = 2;", "constexpr int kTcDepth = 1;")],
    "split: B 2 k-steps ahead": [
        (_TC, "constexpr int DEPTH = NA == 1 ? kTcDepth : 1;", "constexpr int DEPTH = kTcDepth;")],
    "split: one accumulator": [
        (_TC, "mma_bf16(acs[i][2 * q], av,", "mma_bf16(acc[i][2 * q], av,"),
        (_TC, "mma_bf16(acs[i][2 * q + 1], av,", "mma_bf16(acc[i][2 * q + 1], av,")],
    "split: five products (a3 dropped)": [(_TC, "              small(a[2], bq[d][0][q]);\n", "")],
    "warps in a fixed 2 x 8 grid": [
        (_TC, """  const FastDiv md(mgroups);
  for (int u = warp; u < mgroups * ngroups; u += kTcWarps) {
    const int m0 = md.mod(u) * 16 * MT, p0 = md.div(u) * NQ;
""", """  const int wm = warp % 2, wn = warp / 2;
  for (int m0 = wm * 16 * MT; m0 < M; m0 += 64)
  for (int cg = wn; cg < ngroups; cg += 8) {
    const int p0 = cg * NQ;
""")],
    "row positions at each tap": [
        (_TC, "  auto src_of = [&](int r, int rl, int dl) {\n",
         "  auto src_of = [&](int r, int, int dl) {\n    const int rl = r % L;\n")],
    "bf16: parts placed by a division": [
        (_TC, "const int n0 = NA == 1 ? (part <= sc.cap[0] ? 1 : 0) : sc.cap[0] / part;",
         "const int n0 = sc.cap[0] / part;")],
    "m-tiles past M skipped": [
        (_TC, "          uint32_t a[NA][4];\n",
         "          if (m0 + 16 * i >= M) continue;\n          uint32_t a[NA][4];\n")],
    "stage count read after the barrier": [
        (_SB, "const int n_st = (int)net[N_NSTAGES], dim0 = (int)net[N_DIM0];",
         "const int dim0 = (int)net[N_DIM0];"),
        (_SB, "net_body<T, TC>(b, n_st, R,", "net_body<T, TC>(b, (int)net[N_NSTAGES], R,")],
    "net_body not forced inline": [
        (_SB, "__device__ __forceinline__ void net_body(", "__device__ inline void net_body(")],
    "net_step not forced inline": [
        (_SB, "__device__ __forceinline__ const float* net_step(",
         "__device__ inline const float* net_step(")],
    "bf16 churn at 256 threads": [
        (_SB, "template <typename T> constexpr int kChurnThreads = kTcThreads;",
         "template <typename T> constexpr int kChurnThreads = sizeof(T) == 4 ? kTcThreads "
         ": kThreads;")],
    "bf16 churn on the tensor cores": [_BF16_CHURN_TC],
    "bf16 churn on the tensor cores, a fresh accumulator a k-step": [_BF16_CHURN_TC, _FRESH],
    "tensor-core body at 256 threads": [
        (_TC, "constexpr int kTcThreads = 512;", "constexpr int kTcThreads = 256;")],
    "bf16 DDIM step on the tensor cores": [
        (_SB, "template <typename T> constexpr bool kDdimStepTc = sizeof(T) == 4;",
         "template <typename T> constexpr bool kDdimStepTc = true;")],
    "bf16 DDIM step at 256 threads": [
        (_SB, "template <typename T> constexpr int kDdimStepThreads = kTcThreads;",
         "template <typename T> constexpr int kDdimStepThreads = sizeof(T) == 4 ? kTcThreads "
         ": kThreads;")],
    "final block in final_plan's rows, staging room for one A part in OUT": [
        (_K, "  return TC ? stage_plan(L, C, C, E, G) : final_plan(L, C, E, G);",
         "  Plan p = final_plan(L, C, E, G);\n"
         "  if (TC) p.out = up8((L + 1) * (C + 8));\n"
         "  return p;")],
    "final block in final_plan's rows, A value by value": [
        (_K, "  return TC ? stage_plan(L, C, C, E, G) : final_plan(L, C, E, G);",
         "  return final_plan(L, C, E, G);")],
    "fp32 decoder stages in tc_rows_per_block's rows": [
        (_K, "  return launch_rows<T, TC ? kTcThreads : kThreads>(\n"
             "      stage_kernel<T, TC>, stage_plan(L, C, Cout, E, G), BG, st,",
         "  if constexpr (TC && sizeof(T) == 4)\n"
         "    return launch_tc_rows<T>(stage_kernel<T, TC>, stage_plan(L, C, Cout, E, G), L, BG,"
         " st, (const T*)x, (const T*)emb, (const T*)w, net, stage, (T*)out, BG, L, C, Cout, E,"
         " Ce, G);\n"
         "  else return launch_rows<T, TC ? kTcThreads : kThreads>(\n"
         "      stage_kernel<T, TC>, stage_plan(L, C, Cout, E, G), BG, st,")],
    "bf16 DPM++ on the tensor cores": [
        (_SB, "template <typename T> constexpr bool kDpmppTc = sizeof(T) == 4;",
         "template <typename T> constexpr bool kDpmppTc = true;")],
    "bf16 DPM++ at 256 threads": [
        (_SB, "template <typename T> constexpr int kDpmppThreads = kTcThreads;",
         "template <typename T> constexpr int kDpmppThreads = sizeof(T) == 4 ? kTcThreads "
         ": kThreads;")],
}
# the timed calls' sources
_BUILT = {"full": ("full_net.cu",), "ddim": ("kernels.cu", "step_samplers.cu"),
          "stage": ("kernels.cu",), "final": ("kernels.cu",),
          "churn": ("churn_sampler.cu", "step_samplers.cu"), "dpmpp": ("dpmpp_sampler.cu",)}
# the tensor-core kernels --staging counts: source, C entry
_STAGED = {"dpmpp_sampler_kernel": ("dpmpp_sampler.cu", "gl_dpmpp_sample"),
           "churn_sampler_kernel": ("churn_sampler.cu", "gl_churn_sample"),
           "churn_step_kernel": ("step_samplers.cu", "gl_churn_step"),
           "ddim_sampler_kernel": ("kernels.cu", "gl_ddim_sample"),
           "ddim_step_kernel": ("step_samplers.cu", "gl_ddim_step"),
           "stage_kernel": ("kernels.cu", "gl_stage_forward"),
           "final_kernel": ("kernels.cu", "gl_final_forward")}
# block 0's tensor-core products by path (staged, off the k-step, no room)
# and its resblocks by how they run GroupNorm (one pass, two passes)
_STAGING = [
    (_RB, "namespace gl {\n", "namespace gl {\n__device__ unsigned long long gl_staged[5];\n"),
    (_TC, "  if (!fast) {\n",
     "  if (blockIdx.x == 0 && threadIdx.x == 0)\n"
     "    atomicAdd(&gl_staged[fast ? 0 : ((Ck & 15) || (lda & 7)) ? 1 : 2], 1ull);\n"
     "  if (!fast) {\n"),
    (_RB, "  if constexpr (P::kGn) {  // each GroupNorm one pass\n",
     "  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&gl_staged[P::kGn ? 3 : 4], 1ull);\n"
     "  if constexpr (P::kGn) {  // each GroupNorm one pass\n"),
    (_TC, "}  // namespace gl\n", """}  // namespace gl

extern "C" int gl_staging_counts(unsigned long long* out) {
  const unsigned long long zero[5] = {0ull, 0ull, 0ull, 0ull, 0ull};
  cudaError_t e = cudaMemcpyFromSymbol(out, gl::gl_staged, sizeof(zero));
  return (int)(e != cudaSuccess ? e : cudaMemcpyToSymbol(gl::gl_staged, zero, sizeof(zero)));
}
"""),
]


def patched_sources(patches: List[Tuple[str, str, str]]) -> Dict[str, str]:
    """The text of every file the patches touch, patched; raises unless each
    patch's text occurs exactly once."""
    files: Dict[str, str] = {}
    for name, old, new in patches:
        text = files.get(name, (CSRC / name).read_text())
        if text.count(old) != 1:
            raise ValueError(f"{name}: the patch text occurs {text.count(old)} times: {old!r}")
        files[name] = text.replace(old, new)
    return files


# a kernel's ptxas -v report: its short name, spills, registers
_PTXAS = re.compile(r"Function properties for \w*?\d+([a-z_]+_kernel)I(13__nv_bfloat16|f)(Lb[01]E)?E"
                    r"\w*\n"
                    r"\s*\d+ bytes stack frame, (\d+ bytes spill stores, \d+ bytes spill loads)\n"
                    r"[^\n]*Used (\d+) registers")


def _build(variants: Dict[str, object], sources,
           root: str = "variants") -> Dict[str, types.SimpleNamespace]:
    """Each variant's (name -> patches, or another ``csrc`` directory as a
    ``Path``) libraries of ``sources``: its C entries by name."""
    root = BUILD_DIR / root
    shutil.rmtree(root, ignore_errors=True)
    procs = []
    for i, (name, patches) in enumerate(variants.items()):
        d = root / str(i)
        if isinstance(patches, Path):
            shutil.copytree(patches, d)
        else:
            shutil.copytree(CSRC, d)
            for f, text in patched_sources(patches).items():
                (d / f).write_text(text)
        for src in sources:
            cmd = [nvcc_path(), *_FLAGS, "-o", str(d / f"{src}.so"), str(d / src)]
            procs.append((name, d, src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                         stderr=subprocess.PIPE, text=True)))
    libs: Dict[str, types.SimpleNamespace] = {n: types.SimpleNamespace() for n in variants}
    for name, d, src, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} {src}:\n{err[-4000:]}")
        for kernel, dt, tc, spill, regs in _PTXAS.findall(out + err):
            inst = ("fp32" if dt == "f" else "bf16") + (", CUDA cores" if tc == "Lb0E" else "")
            print(f"ptxas {name}: {kernel}<{inst}>: {regs} registers, {spill}", flush=True)
        lib = ctypes.CDLL(str(d / f"{src}.so"))
        for entry, argtypes in _SOURCES[src].items():
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            setattr(libs[name], entry, fn)
    return libs


def _turns(libs, entry: str, call: Callable, reps: int) -> Dict[str, float]:
    """ms of ``call`` with each variant's ``entry`` swapped into the loaded
    namespace, forward then back; the lesser of the two turns."""
    ns = load_library()
    own = getattr(ns, entry)
    order = list(libs) + list(libs)[::-1]
    ms: Dict[str, float] = {}
    try:
        for name in order:
            setattr(ns, entry, getattr(libs[name], entry))
            t = 1e3 * timeit(lambda _: call(), torch.empty(0, device="cuda"), iters=reps)
            ms[name] = min(ms.get(name, t), t)
    finally:
        setattr(ns, entry, own)
    return ms


def _errors(libs, entry: str, call: Callable, ref: torch.Tensor,
            mean: bool = False) -> Dict[str, float]:
    """Each variant's largest (or mean) error of ``call`` with its ``entry``
    against ``ref``, relative to max(1, max|ref|)."""
    ns = load_library()
    own = getattr(ns, entry)
    top = max(1.0, ref.abs().max().item())
    out = {}
    try:
        for name, lib in libs.items():
            setattr(ns, entry, getattr(lib, entry))
            d = (call().float() - ref).abs()
            out[name] = (d.mean() if mean else d.max()).item() / top
    finally:
        setattr(ns, entry, own)
    return out


def _full_operands(w, bg: int, gen, dev):
    """The init conv's output and the FiLM input at random timesteps, as the
    guided samplers make them."""
    d = w.dims
    z = torch.randn((bg, d.cond_channels, d.cond_dim), generator=gen, device=dev)
    t = torch.randint(0, 1000, (bg,), generator=gen, device=dev)
    x = torch.randn((bg, d.seq_len), generator=gen, device=dev)
    emb = compute_emb_s_stacked(w.aux, t, input_emb=compute_input_emb(w.aux, z)).to(w.dtype)
    return sc.init_conv(w, x).reshape(bg, -1).to(w.dtype).contiguous(), emb.contiguous()


def _chain(w, x, emb, cuda_cores: bool = True):
    """The stage chain: 4 ``stage_kernel`` launches and ``final_kernel``; by
    default the float32 CUDA-core control."""
    for i in range(len(w.dims.block_channels)):
        x = sc.stage_apply(w, i, x, emb, cuda_cores=cuda_cores)
    return sc.final_apply(w, x, emb, cuda_cores=cuda_cores)


_PPC = dict(pc_latent_size=256, grasp_latent_size=16)


def _churn_operands(w, ed, bg: int, gen, dev, n: int = 100):
    """The churn kernels' operands over ``bg`` rows: x_T at sigma_max, the
    tables of an ``n``-step trajectory and its unit normals."""
    d = w.dims
    z = torch.randn((bg, d.cond_channels, d.cond_dim), generator=gen, device=dev)
    x_T = ed.sigma_max * torch.randn((bg, d.seq_len), generator=gen, device=dev)
    noise = torch.randn((n, bg, d.seq_len), generator=gen, device=dev)
    return x_T, cs.churn_tables(w, ed, compute_input_emb(w.aux, z), n), noise


def _churn_step(w, x_T, tables, noise, s: int):
    embin, tA, tB, cA, cB = tables
    return cs.churn_step_apply(w, x_T, embin, tA[s], tB[s], cA[s], cB[s], noise[s])


def _churn_steps(w, x_T, tables, noise, n: int, step=cs.churn_step_apply):
    """The state after the first ``n`` churn steps (``step``: the kernel's
    wrapper, or ``churn_step_plain`` with its clamp argument bound)."""
    embin, tA, tB, cA, cB = tables
    x = x_T
    for s in range(n):
        x = step(w, x, embin, tA[s], tB[s], cA[s], cB[s], noise[s])
    return x


def _ddim_tables(w, sched, input_emb, n: int = 100):
    return cs.sampler_tables(w, sched, input_emb, n, "ddim", "fixed_large")


def staging(dev, gen, sched) -> None:
    """Print block 0's tensor-core products by path for one launch of each
    float32 tensor-core sampler kernel (2-step tables: 4 network evaluations
    a churn sampler launch, 2 a churn step, DDIM or DPM++ sampler launch, 1
    a DDIM step) at the fpc and ppc EDM denoisers, and of the float32
    ``stage_kernel`` launches and ``final_kernel`` in both dtypes at the VAE
    decoder (BG = 4096)."""
    root = BUILD_DIR / "staging"
    sources = sorted({src for src, _ in _STAGED.values()})
    libs = _build({"staging": _STAGING}, sources, root=root.name)["staging"]
    reads = {src: ctypes.CDLL(str(root / "0" / f"{src}.so")).gl_staging_counts
             for src in sources}
    ns = load_library()
    own = {entry: getattr(ns, entry) for _, entry in _STAGED.values()}

    def count(name: str, what: str, evals: int, call: Callable, resblocks: int) -> None:
        """``resblocks``: those of one launch, each one pass in float32 and two
        in bf16."""
        read = reads[_STAGED[name][0]]
        got = (ctypes.c_ulonglong * 5)()
        for run in (False, True):  # the first read clears what came before
            if run:
                call()
            torch.cuda.synchronize()
            if read(got) != 0:
                raise RuntimeError("gl_staging_counts failed")
        want = [resblocks, 0] if what.startswith("fp32") else [0, resblocks]
        print(f"staging {name} {what}, block 0 over {evals} evaluation(s): {got[0]} staged, "
              f"{got[1]} value by value (width off the k-step), {got[2]} value by value (no "
              f"room); resblocks {got[3]} with GroupNorm in one pass, {got[4]} in two",
              flush=True)
        if got[2]:
            raise AssertionError(f"{name}: {got[2]} products found no room")
        if [got[3], got[4]] != want:
            raise AssertionError(f"{name}: resblocks in one pass / two {got[3]} / {got[4]}, "
                                 f"not {want}")

    try:
        for entry in own:
            setattr(ns, entry, getattr(libs, entry))
        for label, cfg, bg in (("fpc", {}, 4096), ("ppc", _PPC, 1024)):
            _, ddm, ed = build_flagship(FlagshipConfig(elucidated=True, **cfg),
                                        generator=torch.Generator().manual_seed(0), device=dev)
            dims = _denoiser_dims(ddm)
            w = sc.PackedNet(pack_math_weights(ddm, dims), dims, torch.float32, dev)
            x_T, tables, noise = _churn_operands(w, ed, bg, gen, dev, 2)
            input_emb = tables[0].reshape(bg, dims.cond_channels, -1)
            embin, trows, coefs = _ddim_tables(w, sched, input_emb, 2)
            dp = cs.dpmpp_tables(w, ed, input_emb, 2)
            calls = {
                "dpmpp_sampler_kernel": (2, lambda: cs.dpmpp_sampler_apply(w, x_T, *dp)),
                "churn_sampler_kernel": (4, lambda: cs.churn_sampler_apply(w, x_T, *tables, noise)),
                "churn_step_kernel": (2, lambda: _churn_step(w, x_T, tables, noise, 0)),
                "ddim_sampler_kernel": (2, lambda: cs.sampler_apply(w, x_T, embin, trows, coefs)),
                "ddim_step_kernel": (1, lambda: cs.ddim_step_apply(w, x_T, embin, trows[0],
                                                                   coefs[0])),
            }
            for name, (evals, call) in calls.items():
                count(name, f"fp32 {label} L={dims.seq_len} BG={bg}", evals, call,
                      evals * (2 * len(dims.block_channels) + 1))
        for dt in (torch.bfloat16, torch.float32):
            wd, xs, embd = _decoder_operands(dev, gen, dt)
            tag = "fp32" if dt == torch.float32 else "bf16"
            if dt == torch.float32:
                for i in range(len(xs) - 1):
                    count("stage_kernel", f"fp32 decoder stage {i} L=16 BG=4096", 1,
                          lambda: sc.stage_apply(wd, i, xs[i], embd), 2)
            count("final_kernel", f"{tag} decoder L=16 BG=4096", 1,
                  lambda: sc.final_apply(wd, xs[-1], embd), 1)
    finally:
        for entry, fn in own.items():
            setattr(ns, entry, fn)


def bitwise(libs, dev, gen, sched) -> None:
    """Print, for the tensor-core kernels at the flagships' shapes (fpc BG
    4096, ppc 1024; the decoder's 4 stages and final block at 4096) and the
    float32 CUDA-core control, which variants' outputs are bitwise equal to
    the ``parent`` variant's (``--parent``) on the same operands."""
    def same(entry: str, call: Callable, label: str) -> None:
        ns = load_library()
        own = getattr(ns, entry)
        outs = {}
        try:
            for name, lib in libs.items():
                setattr(ns, entry, getattr(lib, entry))
                outs[name] = call().clone()
                torch.cuda.synchronize()
        finally:
            setattr(ns, entry, own)
        ref = outs.pop("parent")
        print(f"bitwise vs parent, {label}: "
              + " | ".join(f"{n} {torch.equal(o, ref)}" for n, o in outs.items()), flush=True)

    for label, cfg, bg in (("fpc", {}, 4096), ("ppc", _PPC, 1024)):
        _, ddm, ed = build_flagship(FlagshipConfig(elucidated=True, **cfg),
                                    generator=torch.Generator().manual_seed(0), device=dev)
        dims = _denoiser_dims(ddm)
        math_w = pack_math_weights(ddm, dims)
        for dt in (torch.float32, torch.bfloat16):
            w = sc.PackedNet(math_w, dims, dt, dev)
            tag = f"{'fp32' if dt == torch.float32 else 'bf16'} {label} L={dims.seq_len} BG={bg}"
            x, emb = _full_operands(w, bg, gen, dev)
            same("gl_full_forward", lambda: sc.full_apply(w, x, emb), f"full_kernel {tag}")
            x_T, tables, _ = _churn_operands(w, ed, bg, gen, dev, 2)
            input_emb = tables[0].reshape(bg, dims.cond_channels, -1)
            ddim = _ddim_tables(w, sched, input_emb)
            same("gl_ddim_sample", lambda: cs.sampler_apply(w, x_T, *ddim),
                 f"ddim_sampler_kernel {tag} x 100 steps")
            if dt == torch.float32:
                dp = cs.dpmpp_tables(w, ed, input_emb, 32)
                same("gl_dpmpp_sample", lambda: cs.dpmpp_sampler_apply(w, x_T, *dp),
                     f"dpmpp_sampler_kernel {tag} x 32 steps")
    for dt in (torch.float32, torch.bfloat16):
        wd, xs, embd = _decoder_operands(dev, gen, dt)
        tag = f"{'fp32' if dt == torch.float32 else 'bf16'} decoder L=16 BG=4096"
        for cores in (False, True) if dt == torch.float32 else (False,):
            what = ", CUDA-core control" if cores else ""
            same("gl_stage_forward" + ("_cuda_cores" if cores else ""),
                 lambda: torch.cat([sc.stage_apply(wd, i, xs[i], embd, cuda_cores=cores)
                                    .reshape(-1) for i in range(len(xs) - 1)]),
                 f"stage_kernel {tag}, 4 launches{what}")
            same("gl_final_forward" + ("_cuda_cores" if cores else ""),
                 lambda: sc.final_apply(wd, xs[-1], embd, cuda_cores=cores),
                 f"final_kernel {tag}{what}")


def _decoder_operands(dev, gen, dtype=torch.bfloat16):
    """The VAE decoder's pack in ``dtype``, the input of each of its launches
    (4 stages, then the final block) and the FiLM input, over 4096 rows."""
    vae = build_flagship(FlagshipConfig(), generator=torch.Generator().manual_seed(0),
                         device=dev)[0]
    dd = decoder_dims_for(vae)
    wd = sc.PackedNet(pack_math_weights(vae.decoder.net, dd), dd, dtype, dev)
    embd = torch.randn((4096, dd.cond_channels * dd.emb_dim), generator=gen,
                       device=dev).to(dtype)
    xs = [torch.randn((4096, dd.seq_len * C), generator=gen, device=dev).to(dtype)
          for C in dd.cins + (dd.block_channels[-1],)]
    return wd, xs, embd


def _ddim_step_errors(libs, w, sched, input_emb, x_T, n: int = 3) -> Dict[str, float]:
    """Each variant's mean error over the first ``n`` chained DDIM steps of
    its ``ddim_step_kernel`` against ``ddim_step_plain``, relative to
    max(1, max|state|): the largest over the ``n`` states, as
    chip_smoke.py holds them (``step_kernel_phase``)."""
    embin, trows, coefs = _ddim_tables(w, sched, input_emb)
    refs, x = [], x_T
    for s in range(n):
        x = cs.ddim_step_plain(w, x, embin, trows[s], coefs[s], None, True, 1.0)
        refs.append(x)
    ns = load_library()
    own = ns.gl_ddim_step
    out = {}
    try:
        for name, lib in libs.items():
            ns.gl_ddim_step = lib.gl_ddim_step
            x, worst = x_T, 0.0
            for s, ref in enumerate(refs):
                x = cs.ddim_step_apply(w, x, embin, trows[s], coefs[s])
                top = max(1.0, ref.abs().max().item())
                worst = max(worst, (x - ref).abs().mean().item() / top)
            out[name] = worst
    finally:
        ns.gl_ddim_step = own
    return out


def main(argv=None) -> None:
    from ..diffusion import DiffusionSchedule

    p = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    p.add_argument("variants", nargs="*", help=f"default: all of {list(VARIANTS)}")
    p.add_argument("--kernels", nargs="+", choices=list(_BUILT), default=list(_BUILT),
                   help="the timed calls (default: all)")
    p.add_argument("--staging", action="store_true",
                   help="also count the tensor-core kernels' products by path")
    p.add_argument("--parent", type=Path, default=None,
                   help="another tree's csrc directory, timed as the variant 'parent'; each "
                        "variant's outputs are held bitwise against it")
    args = p.parse_args(argv)
    names = args.variants or list(VARIANTS)
    if "as built" not in names:
        names = ["as built"] + names
    variants: Dict[str, object] = {n: VARIANTS[n] for n in names}
    if args.parent is not None:
        names = ["parent"] + names
        variants = {"parent": args.parent.resolve(), **variants}
    kernels = set(args.kernels)
    dev = resolve_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(device_line(dev), flush=True)
    load_library()
    gen = torch.Generator(device=dev).manual_seed(0)
    sched = DiffusionSchedule.create(num_steps=1000, beta_start=5e-5, beta_end=1e-3)
    if args.staging:
        staging(dev, gen, sched)
    sources = {f for k in kernels for f in _BUILT[k]}
    if args.parent is not None:
        sources |= {"kernels.cu", "full_net.cu", "dpmpp_sampler.cu"}
    libs = _build({n: variants[n] for n in names}, sorted(sources))
    if args.parent is not None:
        bitwise(libs, dev, gen, sched)

    def report(label, ms, err=None, chain=None, what="err"):
        parts = [f"{n} {ms[n]:.3f} ms" + (f" ({what} {err[n]:.2e})" if err else "")
                 for n in names]
        print(f"{label}" + (f", chain err {chain:.2e}" if chain is not None else "") + ": "
              + " | ".join(parts), flush=True)

    for cfg, shapes, churn in (({}, ((torch.float32, 8192), (torch.float32, 4096),
                                     (torch.bfloat16, 4096)), 4096),
                               (_PPC, ((torch.float32, 2048),), 1024)):
        _, ddm, ed = build_flagship(FlagshipConfig(elucidated=True, **cfg),
                                    generator=torch.Generator().manual_seed(0), device=dev)
        dims = _denoiser_dims(ddm)
        math_w = pack_math_weights(ddm, dims)
        for dt, bg in shapes if "full" in kernels else ():
            w = sc.PackedNet(math_w, dims, dt, dev)
            x, emb = _full_operands(w, bg, gen, dev)
            ref = sc.full_plain(w, x, emb).float()
            # float32: the CUDA-core control's chain; bf16 has none, its own chain
            chain = (_chain(w, x, emb, dt == torch.float32).float() - ref).abs().max().item()
            top = max(1.0, ref.abs().max().item())
            call = lambda: sc.full_apply(w, x, emb)  # noqa: E731
            report(f"full_kernel {'fp32' if dt == torch.float32 else 'bf16'} L={dims.seq_len} "
                   f"BG={bg}", _turns(libs, "gl_full_forward", call, 10),
                   _errors(libs, "gl_full_forward", call, ref), chain / top)
        for dt in (torch.bfloat16, torch.float32) if "churn" in kernels else ():
            w = sc.PackedNet(math_w, dims, dt, dev)
            x_T, tables, noise = _churn_operands(w, ed, churn, gen, dev)
            tag = f"{'fp32' if dt == torch.float32 else 'bf16'} L={dims.seq_len} BG={churn}"
            # and over a 2-step trajectory (TOL_BF16_EDM_STEP_MEAN, 2^-10.5 = 6.9e-4)
            x2, t2, n2 = _churn_operands(w, ed, churn, gen, dev, 2)
            ref2 = cs.churn_sampler_plain(w, x2, *t2, n2, False)
            report(f"churn_sampler_kernel {tag} x 100 steps",
                   _turns(libs, "gl_churn_sample",
                          lambda: cs.churn_sampler_apply(w, x_T, *tables, noise), 2),
                   _errors(libs, "gl_churn_sample",
                           lambda: cs.churn_sampler_apply(w, x2, *t2, n2), ref2.float(), True),
                   what="2-step trajectory mean err")
            # the bf16 rounding points: the mean error of the first 3 steps
            # (chip_smoke.py's TOL_BF16_STEP_MEAN["churn"], 2^-22 = 2.4e-7)
            ref = _churn_steps(w, x_T, tables, noise, 3,
                               lambda *a: cs.churn_step_plain(*a, False))
            report(f"churn_step_kernel {tag}, one launch (step 50)",
                   _turns(libs, "gl_churn_step",
                          lambda: _churn_step(w, x_T, tables, noise, 50), 10),
                   _errors(libs, "gl_churn_step",
                           lambda: _churn_steps(w, x_T, tables, noise, 3), ref.float(), True),
                   what="3-step mean err")
        for dt in (torch.bfloat16, torch.float32) if "dpmpp" in kernels else ():
            w = sc.PackedNet(math_w, dims, dt, dev)
            x_T, tables, _ = _churn_operands(w, ed, churn, gen, dev, 2)
            dp = cs.dpmpp_tables(w, ed, tables[0].reshape(churn, dims.cond_channels, -1), 32)
            tag = f"{'fp32' if dt == torch.float32 else 'bf16'} L={dims.seq_len} BG={churn}"
            call = lambda: cs.dpmpp_sampler_apply(w, x_T, *dp)  # noqa: E731
            if dt == torch.float32:  # chip_smoke.py holds it at TOL_FP32 (1e-4)
                err = _errors(libs, "gl_dpmpp_sample", call,
                              cs.dpmpp_sampler_plain(w, x_T, *dp, False))
                what = "max err"
            else:  # the 2-step trajectory's mean (TOL_BF16_EDM_STEP_MEAN, 6.9e-4)
                dp2 = cs.dpmpp_tables(w, ed, tables[0].reshape(churn, dims.cond_channels, -1), 2)
                err = _errors(libs, "gl_dpmpp_sample",
                              lambda: cs.dpmpp_sampler_apply(w, x_T, *dp2),
                              cs.dpmpp_sampler_plain(w, x_T, *dp2, False), True)
                what = "2-step trajectory mean err"
            report(f"dpmpp_sampler_kernel {tag} x 32 steps",
                   _turns(libs, "gl_dpmpp_sample", call, 3), err, what=what)
        if "ddim" in kernels:
            # chip_smoke.py's step-kernel operands: its seed (SEED + 8), its draws
            g8 = torch.Generator(device=dev).manual_seed(8)
            z = torch.randn((churn, 3, dims.cond_dim), generator=g8, device=dev)
            x_unit = torch.randn((churn, dims.seq_len), generator=g8, device=dev)
            for dt in (torch.bfloat16, torch.float32):
                w = sc.PackedNet(math_w, dims, dt, dev)
                tag = f"{'fp32' if dt == torch.float32 else 'bf16'} L={dims.seq_len}"
                emb = compute_input_emb(w.aux, z)
                tables = _ddim_tables(w, sched, emb)
                call = lambda: cs.sampler_apply(w, x_unit, *tables)  # noqa: E731
                err = None
                if dt == torch.float32:  # chip_smoke.py holds it at TOL_FP32 (1e-4)
                    ref = cs.sampler_plain(w, x_unit, *tables, None, True, 1.0)
                    err = _errors(libs, "gl_ddim_sample", call, ref)
                report(f"ddim_sampler_kernel {tag} BG={churn} x 100 steps",
                       _turns(libs, "gl_ddim_sample", call, 2), err, what="max err")
                embin, trows, coefs = tables
                ms = _turns(libs, "gl_ddim_step",
                            lambda: cs.ddim_step_apply(w, x_unit, embin, trows[50], coefs[50]), 10)
                for bg in (churn, 1021):
                    err = _ddim_step_errors(libs, w, sched, emb[:bg], x_unit[:bg].contiguous())
                    report(f"ddim_step_kernel {tag} BG={churn}, one launch (step 50); "
                           f"3-step mean err at BG={bg}", ms, err, what="3-step mean err")
    if not kernels & {"stage", "final"}:
        return
    for dt in (torch.bfloat16, torch.float32):
        wd, xs, embd = _decoder_operands(dev, gen, dt)
        tag = "fp32" if dt == torch.float32 else "bf16"
        fp32 = dt == torch.float32
        if "stage" in kernels:
            # float32: each variant's largest error over the 4 launches against
            # stage_plain, beside the CUDA-core control's
            refs = [sc.stage_plain(wd, i, xs[i], embd).float() for i in range(len(xs) - 1)]
            top = max(max(1.0, r.abs().max().item()) for r in refs)

            def stages(cuda_cores=False):
                return [sc.stage_apply(wd, i, xs[i], embd, cuda_cores=cuda_cores)
                        for i in range(len(xs) - 1)]

            def worst():  # relative to the largest max(1, max|ref|) of the 4
                return torch.stack([(g.float() - r).abs().max() for g, r in
                                    zip(stages(), refs)]).max() / top

            control = None
            if fp32:
                control = max((g.float() - r).abs().max().item()
                              for g, r in zip(stages(True), refs)) / top
                control_ms = 1e3 * timeit(lambda _: stages(True), torch.empty(0, device=dev),
                                          iters=10)
                print(f"stage_kernel fp32 CUDA-core control, a decode's 4 launches: "
                      f"{control_ms:.3f} ms", flush=True)
            report(f"stage_kernel {tag} L=16 BG=4096, a decode's 4 launches",
                   _turns(libs, "gl_stage_forward", stages, 10),
                   _errors(libs, "gl_stage_forward", worst, torch.zeros(())) if fp32 else None,
                   control, what="max err")
        if "final" in kernels:
            for bg in (4096, 1021):
                x, emb = xs[-1][:bg].contiguous(), embd[:bg].contiguous()
                ref = sc.final_plain(wd, x, emb).float()
                control = None
                if fp32:
                    control = ((sc.final_apply(wd, x, emb, cuda_cores=True).float() - ref)
                               .abs().max().item() / max(1.0, ref.abs().max().item()))
                report(f"final_kernel {tag} L=16 BG={bg}",
                       _turns(libs, "gl_final_forward", lambda: sc.final_apply(wd, x, emb), 10),
                       _errors(libs, "gl_final_forward", lambda: sc.final_apply(wd, x, emb),
                               ref), control)


if __name__ == "__main__":
    main()
