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
to max(1, max|ref|), beside the float32 stage chain's (the CUDA cores).

    python -m graspldm_tpu_torch.tools.kernel_variants [VARIANT ...]

Needs a card and ``nvcc``; it raises without them.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import types
from typing import Callable, Dict, List, Tuple

import torch

from ..cuda_build import _FLAGS, _SOURCES, BUILD_DIR, CSRC, load_library, nvcc_path
from ..flagship import FlagshipConfig, build_flagship, resolve_device
from ..inference.pipeline import _denoiser_dims
from ..models import stacked_cuda as sc
from ..models.fast_decoder import decoder_dims_for
from ..models.stacked_denoiser import (
    compute_emb_s_stacked, compute_input_emb, pack_math_weights,
)
from ..utils.profiling import device_line, timeit

__all__ = ["VARIANTS", "patched_sources", "main"]

_TC, _SB = "tc_blocks.cuh", "sampler_body.cuh"
# name -> [(file, text, replacement)]: each undoes one decision
VARIANTS: Dict[str, List[Tuple[str, str, str]]] = {
    "as built": [],
    "fp32 fpc at 9 rows": [("full_net.cu", "  if (R * L > 32) R -= (R * L % 32) / L;\n", "")],
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
}
_BUILT = ("kernels.cu", "full_net.cu")  # the timed kernels' sources


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


def _build(names: List[str]) -> Dict[str, types.SimpleNamespace]:
    """Each variant's libraries of _BUILT: its C entries by name."""
    root = BUILD_DIR / "variants"
    shutil.rmtree(root, ignore_errors=True)
    procs = []
    for i, name in enumerate(names):
        d = root / str(i)
        shutil.copytree(CSRC, d)
        for f, text in patched_sources(VARIANTS[name]).items():
            (d / f).write_text(text)
        for src in _BUILT:
            cmd = [nvcc_path(), *_FLAGS, "-o", str(d / f"{src}.so"), str(d / src)]
            procs.append((name, d, src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                         stderr=subprocess.PIPE, text=True)))
    libs: Dict[str, types.SimpleNamespace] = {n: types.SimpleNamespace() for n in names}
    for name, d, src, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} {src}:\n{err[-4000:]}")
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


def _errors(libs, call: Callable, ref: torch.Tensor) -> Dict[str, float]:
    ns = load_library()
    own = ns.gl_full_forward
    top = max(1.0, ref.abs().max().item())
    out = {}
    try:
        for name, lib in libs.items():
            ns.gl_full_forward = lib.gl_full_forward
            out[name] = (call().float() - ref).abs().max().item() / top
    finally:
        ns.gl_full_forward = own
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


def _chain(w, x, emb):
    for i in range(len(w.dims.block_channels)):
        x = sc.stage_apply(w, i, x, emb)
    return sc.final_apply(w, x, emb)


def main(argv=None) -> None:
    from ..models import cuda_sampler as cs
    from ..diffusion import DiffusionSchedule

    p = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    p.add_argument("variants", nargs="*", help=f"default: all of {list(VARIANTS)}")
    names = p.parse_args(argv).variants or list(VARIANTS)
    if "as built" not in names:
        names = ["as built"] + names
    dev = resolve_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(device_line(dev), flush=True)
    load_library()
    libs = _build(names)
    gen = torch.Generator(device=dev).manual_seed(0)

    def report(label, ms, err=None, chain=None):
        parts = [f"{n} {ms[n]:.3f} ms" + (f" (err {err[n]:.2e})" if err else "") for n in names]
        print(f"{label}" + (f", chain err {chain:.2e}" if chain is not None else "") + ": "
              + " | ".join(parts), flush=True)

    for cfg, shapes in (({}, ((torch.float32, 8192), (torch.float32, 4096),
                              (torch.bfloat16, 4096))),
                        (dict(pc_latent_size=256, grasp_latent_size=16),
                         ((torch.float32, 2048),))):
        vae, ddm, diff = build_flagship(FlagshipConfig(elucidated=True, **cfg),
                                        generator=torch.Generator().manual_seed(0), device=dev)
        dims = _denoiser_dims(ddm)
        math_w = pack_math_weights(ddm, dims)
        for dt, bg in shapes:
            w = sc.PackedNet(math_w, dims, dt, dev)
            x, emb = _full_operands(w, bg, gen, dev)
            ref = sc.full_plain(w, x, emb).float()
            chain = (_chain(w, x, emb).float() - ref).abs().max().item()
            top = max(1.0, ref.abs().max().item())
            call = lambda: sc.full_apply(w, x, emb)  # noqa: E731
            report(f"full_kernel {'fp32' if dt == torch.float32 else 'bf16'} L={dims.seq_len} "
                   f"BG={bg}", _turns(libs, "gl_full_forward", call, 10),
                   _errors(libs, call, ref), chain / top)
    vae, ddm, diff = build_flagship(FlagshipConfig(), generator=torch.Generator().manual_seed(0),
                                    device=dev)
    dims = _denoiser_dims(ddm)
    sched = DiffusionSchedule.create(num_steps=1000, beta_start=5e-5, beta_end=1e-3)
    z = torch.randn((4096, 3, dims.cond_dim), generator=gen, device=dev)
    x_T = torch.randn((4096, dims.seq_len), generator=gen, device=dev)
    for dt in (torch.bfloat16, torch.float32):
        w = sc.PackedNet(pack_math_weights(ddm, dims), dims, dt, dev)
        tables = cs.sampler_tables(w, sched, compute_input_emb(w.aux, z), 100, "ddim",
                                   "fixed_large")
        report(f"ddim_sampler_kernel {'fp32' if dt == torch.float32 else 'bf16'} L=4 BG=4096 "
               f"x 100 steps", _turns(libs, "gl_ddim_sample",
                                      lambda: cs.sampler_apply(w, x_T, *tables), 2))
    dd = decoder_dims_for(vae)
    wd = sc.PackedNet(pack_math_weights(vae.decoder.net, dd), dd, torch.bfloat16, dev)
    embd = torch.randn((4096, dd.cond_channels * dd.emb_dim), generator=gen,
                       device=dev).to(torch.bfloat16)
    xs = [torch.randn((4096, dd.seq_len * C), generator=gen, device=dev).to(torch.bfloat16)
          for C in dd.cins]
    report("stage_kernel bf16 L=16 BG=4096, a decode's 4 launches",
           _turns(libs, "gl_stage_forward",
                  lambda: [sc.stage_apply(wd, i, xs[i], embd) for i in range(len(xs))], 10))


if __name__ == "__main__":
    main()
