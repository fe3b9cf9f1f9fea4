"""The port's kernel wrappers and its JAX-free import surface.

This file imports torch and numpy only (no JAX), so the ``cuda`` tests run
on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_port_kernels.py

Without a card they skip. The other tests run anywhere: a CPU tensor takes
each wrapper's plain PyTorch version and counts no launch, and a tensor on
any other device is refused rather than quietly computed elsewhere.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from graspldm_tpu_torch.diffusion import DiffusionSchedule, ElucidatedDiffusion
from graspldm_tpu_torch.inference.pipeline import _denoiser_dims
from graspldm_tpu_torch.models import GraspCVAE, GraspLatentDDM
from graspldm_tpu_torch.models import cuda_sampler as cs
from graspldm_tpu_torch.models import stacked_cuda as sc
from graspldm_tpu_torch.models.fast_decoder import decoder_dims_for
from graspldm_tpu_torch.models.stacked_denoiser import (
    FLAGSHIP_DIMS,
    compute_input_emb,
    pack_math_weights,
)
from graspldm_tpu_torch.ops import cuda_fps
from graspldm_tpu_torch.tools import bench_mm, bench_repeat, bench_silu

REPO = Path(__file__).resolve().parents[1]


def _counts():
    return tuple(k.launches for k in (sc.STAGE_KERNEL, sc.FINAL_KERNEL, sc.FULL_KERNEL,
                                      sc.HYBRID_STAGE_KERNEL, sc.HYBRID_FINAL_KERNEL,
                                      cs.SAMPLER_KERNEL, cs.DPMPP_KERNEL, cs.CHURN_KERNEL,
                                      cs.DDIM_STEP_KERNEL, cs.DPMPP_STEP_KERNEL,
                                      cs.CHURN_STEP_KERNEL, cuda_fps.FPS_KERNEL,
                                      bench_mm.MM_CHAIN_KERNEL, bench_silu.SILU_CHAIN_KERNEL,
                                      bench_repeat.BCAST_CHAIN_KERNEL))


@pytest.fixture(scope="module")
def nets():
    torch.manual_seed(0)
    vae = GraspCVAE(dropout=None, pc_num_points=32, pc_scale_channels=0.25,
                    pc_scale_voxel_resolution=0.25).eval()
    ddm = GraspLatentDDM(dropout=None).eval()
    # the ppc denoiser: latent 16 (so L = 16), z_pc [3, 256]
    ddm16 = GraspLatentDDM(latent_in_features=16, pc_latent_size=256, dropout=None).eval()
    dims16 = _denoiser_dims(ddm16)
    ddims = decoder_dims_for(vae)
    return dict(dec_math=pack_math_weights(vae.decoder.net, ddims), dec_dims=ddims,
                den_math=pack_math_weights(ddm, FLAGSHIP_DIMS),
                den={4: (pack_math_weights(ddm, FLAGSHIP_DIMS), FLAGSHIP_DIMS),
                     16: (pack_math_weights(ddm16, dims16), dims16)})


def test_port_never_imports_jax():
    """Every module of the port imports without loading jax or flax (the
    card's machine has neither)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import graspldm_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'flax', 'graspldm_tpu', 'tools'))\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 22, mods\n"
        "for need in ('models.conditioning', 'diffusion.guidance', 'models.pvcnn2',\n"
        "             'ops.cuda_fps', 'ops.neighborhood', 'ops.sampling',\n"
        "             'models.stacked_cuda', 'models.stacked_denoiser', 'models.layers',\n"
        "             'models.pvcnn', 'diffusion.schedules', 'inference.pipeline',\n"
        "             'tools.bench_mm', 'tools.bench_silu', 'tools.bench_repeat',\n"
        "             'utils.profiling'):\n"
        "    assert p.__name__ + '.' + need in mods, need\n"
        "from graspldm_tpu_torch.models.stacked_cuda import hybrid_stage_apply\n"
        "from graspldm_tpu_torch.models.stacked_denoiser import attention_stacked\n"
        "from graspldm_tpu_torch.models.pvcnn import GlobalAttention, VoxelAttention\n"
        "from graspldm_tpu_torch.models.layers import Attention1D\n"
        "from graspldm_tpu_torch.inference.pipeline import resolve_denoiser_impl\n"
        "from graspldm_tpu_torch.tools.bench_mm import mm_chain_apply\n"
        "from graspldm_tpu_torch.utils.profiling import timeit\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'flax', 'graspldm_tpu', 'tools'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    src = (REPO / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(from|import)\s+(jax|flax|graspldm_tpu|tools)\b", src, re.M)


def test_chip_smoke_refuses_to_run_without_a_card():
    """No CUDA device: chip_smoke.py exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_wrappers_run_plain_versions_on_cpu(nets):
    w = sc.PackedNet(nets["dec_math"], nets["dec_dims"])
    d = nets["dec_dims"]
    g = torch.Generator().manual_seed(1)
    x = torch.randn(5, d.seq_len * d.cins[1], generator=g)
    emb = torch.randn(5, d.cond_channels * d.emb_dim, generator=g)
    before = _counts()
    torch.testing.assert_close(sc.stage_apply(w, 1, x, emb), sc.stage_plain(w, 1, x, emb),
                               rtol=0, atol=0)
    h = torch.randn(5, d.seq_len * d.block_channels[-1], generator=g)
    torch.testing.assert_close(sc.final_apply(w, h, emb), sc.final_plain(w, h, emb),
                               rtol=0, atol=0)
    x0 = torch.randn(5, d.seq_len * d.cins[0], generator=g)
    torch.testing.assert_close(sc.full_apply(w, x0, emb), sc.full_plain(w, x0, emb),
                               rtol=0, atol=0)
    assert _counts() == before


def test_hybrid_wrappers_run_plain_versions_on_cpu(nets):
    """On CPU tensors the hybrid wrappers run their plain versions and count
    no launch; stage 0 takes its own width, stage i the previous stage's."""
    d = nets["dec_dims"]
    w = sc.PackedNet(nets["dec_math"], d)
    g = torch.Generator().manual_seed(3)
    emb = torch.randn(5, d.cond_channels * d.emb_dim, generator=g)
    before = _counts()
    for i in range(len(d.block_channels) + 1):
        x = torch.randn(5, d.seq_len * d.cins[max(i - 1, 0)], generator=g)
        if i < len(d.block_channels):
            got, ref = sc.hybrid_stage_apply(w, i, x, emb), sc.hybrid_stage_plain(w, i, x, emb)
            assert got.shape == (5, d.seq_len * d.cins[i])
        else:
            got, ref = sc.hybrid_final_apply(w, x, emb), sc.hybrid_final_plain(w, x, emb)
            assert got.shape == (5, d.seq_len)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert _counts() == before


def test_edm_wrappers_run_plain_versions_on_cpu(nets):
    """On CPU tensors the EDM sampler wrappers are their plain versions,
    launch nothing, and keep x_T's shape."""
    math, dims = nets["den"][4]
    w = sc.PackedNet(math, dims)
    g = torch.Generator().manual_seed(4)
    ed, N, BG = ElucidatedDiffusion(n_dims=4), 3, 5
    input_emb = compute_input_emb(w.aux, torch.randn(BG, 3, 64, generator=g))
    x_T = 80.0 * torch.randn(BG, 4, generator=g)
    noise = torch.randn(N, BG, 4, generator=g)
    before = _counts()
    dp = cs.dpmpp_tables(w, ed, input_emb, N)
    got = cs.dpmpp_sampler_apply(w, x_T, *dp)
    torch.testing.assert_close(got, cs.dpmpp_sampler_plain(w, x_T, *dp, False), rtol=0, atol=0)
    ch = cs.churn_tables(w, ed, input_emb, N)
    got = cs.churn_sampler_apply(w, x_T, *ch, noise)
    torch.testing.assert_close(got, cs.churn_sampler_plain(w, x_T, *ch, noise, False),
                               rtol=0, atol=0)
    assert got.shape == (BG, 4) and bool(torch.isfinite(got).all())
    assert _counts() == before


SCHEDULE = dict(num_steps=1000, beta_start=5e-5, beta_end=1e-3)  # the flagship's


def _trajectory_run(w, sampler: str, BG: int, n: int, gen: torch.Generator):
    """One ``sampler`` trajectory of ``n`` steps (n divides T = 1000, so the
    DDIM / DDPM grid has n steps) over BG rows of ``w``'s
    denoiser, on seeded inputs: the trajectory path (``traj``, one step
    wrapper per step, counted by ``counter``), the same steps' plain
    versions chained (``traj_plain``, the states without the trailing
    unit axis) and the whole-trajectory wrapper and plain version
    (``whole``, ``whole_plain``)."""
    dev, L = w.device, w.dims.seq_len
    z_pc = torch.randn(BG, 3, w.dims.cond_dim, generator=gen, device=dev)
    input_emb = compute_input_emb(w.aux, z_pc)
    x_unit = torch.randn(BG, L, generator=gen, device=dev)
    noise = torch.randn(n, BG, L, generator=gen, device=dev)
    ed = ElucidatedDiffusion(n_dims=L)
    if sampler in ("ddim", "ddpm"):
        sched = DiffusionSchedule.create(**SCHEDULE)
        nz = noise if sampler == "ddpm" else None
        tb = cs.sampler_tables(w, sched, input_emb, n, sampler, "fixed_large")
        embin, trows, coefs = tb

        def plain():
            states = [x_unit]
            for s in range(n):
                states.append(cs.ddim_step_plain(w, states[-1], embin, trows[s], coefs[s],
                                                 None if nz is None else nz[s], True, 1.0))
            return torch.stack(states)

        return dict(
            traj=lambda: cs.fused_sample(w, sched, input_emb, x_unit, n, sampler, noise=nz,
                                         return_trajectory=True),
            traj_plain=plain, counter=cs.DDIM_STEP_KERNEL,
            whole=lambda: cs.sampler_apply(w, x_unit, *tb, nz),
            whole_plain=lambda: cs.sampler_plain(w, x_unit, *tb, nz, True, 1.0))
    x_T = 80.0 * x_unit
    if sampler == "dpmpp":
        tb = cs.dpmpp_tables(w, ed, input_emb, n)
        embin, trows, coefs = tb

        def plain():
            x, old, states = x_T, torch.zeros_like(x_T), []
            for s in range(n):
                x, old = cs.dpmpp_step_plain(w, x, old, embin, trows[s], coefs[s], False)
                states.append(x)
            return torch.stack(states)

        return dict(
            traj=lambda: cs.fused_sample_dpmpp(w, ed, input_emb, x_T, n, return_trajectory=True),
            traj_plain=plain, counter=cs.DPMPP_STEP_KERNEL,
            whole=lambda: cs.dpmpp_sampler_apply(w, x_T, *tb),
            whole_plain=lambda: cs.dpmpp_sampler_plain(w, x_T, *tb, False))
    tb = cs.churn_tables(w, ed, input_emb, n)

    def plain():
        states = [x_T]
        for s in range(n):
            states.append(cs.churn_step_plain(w, states[-1], tb[0], tb[1][s], tb[2][s], tb[3][s],
                                              tb[4][s], noise[s], False))
        return torch.stack(states)

    return dict(
        traj=lambda: cs.fused_sample_churn(w, ed, input_emb, x_T, n, noise=noise,
                                           return_trajectory=True),
        traj_plain=plain, counter=cs.CHURN_STEP_KERNEL,
        whole=lambda: cs.churn_sampler_apply(w, x_T, *tb, noise),
        whole_plain=lambda: cs.churn_sampler_plain(w, x_T, *tb, noise, False))


@pytest.mark.parametrize("sampler", ["ddim", "ddpm", "dpmpp", "churn"])
def test_trajectory_loops_are_the_whole_trajectory_plain_versions_on_cpu(nets, sampler):
    """On the CPU the trajectory path (one step wrapper per step, each
    running its plain step) ends bitwise where the whole-trajectory plain
    version does, which is now a loop over the same plain steps; no launch
    is counted, and the trajectory has JAX's length."""
    math, dims = nets["den"][4]
    w = sc.PackedNet(math, dims)
    n = 4
    run = _trajectory_run(w, sampler, 5, n, torch.Generator().manual_seed(7))
    before = _counts()
    x0, traj = run["traj"]()
    assert traj.shape == (n if sampler == "dpmpp" else n + 1, 5, 1, 4)
    assert torch.equal(x0, traj[-1])
    assert torch.equal(x0[:, 0], run["whole_plain"]())
    assert torch.equal(x0[:, 0], run["whole"]())
    assert torch.equal(traj[:, :, 0], run["traj_plain"]())
    assert _counts() == before


def test_step_wrappers_write_into_their_outputs_on_cpu(nets):
    """Given ``out`` (a trajectory's row), a step wrapper writes its plain
    step there and returns it."""
    math, dims = nets["den"][4]
    w = sc.PackedNet(math, dims)
    g = torch.Generator().manual_seed(8)
    ed, BG = ElucidatedDiffusion(n_dims=4), 5
    input_emb = compute_input_emb(w.aux, torch.randn(BG, 3, 64, generator=g))
    x = 80.0 * torch.randn(BG, 4, generator=g)
    noise = torch.randn(BG, 4, generator=g)
    embin, trowsA, trowsB, coefA, coefB = cs.churn_tables(w, ed, input_emb, 2)
    out = torch.full((2, BG, 4), float("nan"))
    got = cs.churn_step_apply(w, x, embin, trowsA[0], trowsB[0], coefA[0], coefB[0], noise,
                              out=out[1])
    assert got.data_ptr() == out[1].data_ptr()
    want = cs.churn_step_plain(w, x, embin, trowsA[0], trowsB[0], coefA[0], coefB[0], noise,
                               False)
    assert torch.equal(out[1], want) and bool(torch.isnan(out[0]).all())
    embin, trows, coefs = cs.dpmpp_tables(w, ed, input_emb, 2)
    dens = torch.zeros(2, BG, 4)
    x_new, den = cs.dpmpp_step_apply(w, x, dens[0], embin, trows[0], coefs[0], out=out[0],
                                     den_out=dens[1])
    want = cs.dpmpp_step_plain(w, x, dens[0], embin, trows[0], coefs[0], False)
    assert torch.equal(out[0], want[0]) and torch.equal(dens[1], want[1])
    assert x_new.data_ptr() == out[0].data_ptr() and den.data_ptr() == dens[1].data_ptr()


def test_entry_points_refuse_to_build_on_the_cpu_unasked(monkeypatch):
    """With no card and no device named, the entry points raise instead of
    quietly building on the CPU; naming the CPU builds there."""
    from graspldm_tpu_torch.flagship import FlagshipConfig, build_flagship
    from graspldm_tpu_torch.serving import make_batch_generate_from_parts

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = FlagshipConfig(pc_num_points=32, pc_scale_channels=0.125,
                         pc_scale_voxel_resolution=0.25, block_channels=(8, 16))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_flagship()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_flagship(cfg)
    vae, ddm, diff = build_flagship(cfg, device="cpu")
    assert next(vae.parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batch_generate_from_parts(vae, ddm, diff)


def _unfragment(frag: torch.Tensor, taps: int, Ck: int, N: int) -> torch.Tensor:
    """The padded [taps * Ck16, N16] matrix a tc_fragments copy holds, read
    back through the lane map csrc/tc_blocks.cuh loads it by: lane 4g + t of
    column pair p at k-step s holds, for n-tile j, W[16s + 8q + 2t + h,
    16p + 8j + g] at position 4j + 2q + h of its 8 values."""
    ck16, n16 = (Ck + 15) // 16 * 16, (N + 15) // 16 * 16
    KS, NP = taps * ck16 // 16, n16 // 16
    out = torch.full((taps * ck16, n16), float("nan"))
    vals = frag.float().reshape(KS, NP, 32, 8)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for v in range(8):
            j, q, h = v // 4, (v // 2) % 2, v % 2
            k = torch.arange(KS)[:, None] * 16 + 8 * q + 2 * t + h
            n = torch.arange(NP)[None, :] * 16 + 8 * j + g
            out[k, n] = vals[:, :, lane, v]
    return out


# (taps, Ck, N): the narrow first stage (the init conv emits L channels), the
# flagship convs and projections, wqkv and wo, and widths off the 16 grid
TC_SHAPES = [(3, 4, 4), (3, 4, 32), (3, 32, 64), (3, 128, 256), (3, 256, 256), (1, 4, 384),
             (1, 128, 4), (3, 8, 16), (1, 24, 40)]


@pytest.mark.parametrize("taps,Ck,N", TC_SHAPES)
def test_tc_fragments_round_trip_to_the_math_form(taps, Ck, N):
    """The fragment-ordered weights of ddim_sampler_kernel's tensor-core
    products hold the math form bitwise where the lane map puts it, and
    zeros in every padded row (each tap's Ck up to 16) and column (N up to
    16); every position is written once."""
    W = torch.randn(taps * Ck, N, generator=torch.Generator().manual_seed(taps * 1000 + Ck + N))
    W = W.to(torch.bfloat16).float()
    frag = sc.tc_fragments(W, taps)
    ck16, n16 = (Ck + 15) // 16 * 16, (N + 15) // 16 * 16
    assert frag.numel() == taps * ck16 * n16
    got = _unfragment(frag, taps, Ck, N)
    assert not torch.isnan(got).any()
    padded = got.reshape(taps, ck16, n16)
    assert torch.equal(padded[:, :Ck, :N].reshape(taps * Ck, N), W)
    assert not padded[:, Ck:].any() and not padded[:, :, N:].any()


@pytest.mark.parametrize("L", [4, 16])
def test_bf16_pack_carries_the_tensor_core_table(nets, L):
    """A bf16 PackedNet appends each tensor-core product's fragment-ordered
    weights after the math form and points the layout's table at them; the
    math form is unchanged (a float32 pack's table, of the exact bf16 split,
    is held in test_torch_port_split.py)."""
    math, dims = nets["den"][L]
    f32 = sc.PackedNet(math, dims, torch.float32)
    w = sc.PackedNet(math, dims, torch.bfloat16)
    assert torch.equal(w.math_flat, f32.math_flat.to(torch.bfloat16))
    table = w.layout[int(w.layout[sc.N_TC]):].tolist()
    n = len(dims.block_channels)
    assert len(table) == (n + 1) * sc.TC_REC
    names = [(f"b{i}{r}_{s}", 3) for i in range(n) for r in ("r1", "r2") for s in ("w1", "w2")]
    slots = [(i * sc.TC_REC + sc.TC_SLOTS.index(f"{r}_{s}")) for i in range(n)
             for r in ("r1", "r2") for s in ("w1", "w2")]
    for i in range(n):
        names += [(f"b{i}_wqkv", 1), (f"b{i}_wo", 1), (f"b{i}_wp", 3)]
        slots += [i * sc.TC_REC + sc.TC_SLOTS.index(k) for k in ("wqkv", "wo", "wp")]
    names += [("final_w1", 3), ("final_w2", 3)]
    slots += [n * sc.TC_REC, n * sc.TC_REC + 1]
    for (name, taps), slot in zip(names, slots):
        want = sc.tc_fragments(w.w[name].float(), taps).to(torch.bfloat16)
        off = table[slot]
        assert off >= w.n_math and off % 8 == 0, name
        assert torch.equal(w.flat[off: off + want.numel()], want), name


def test_wrappers_refuse_other_devices(nets):
    """A tensor neither on the CPU nor on a CUDA card is refused: there is
    no path that quietly computes somewhere else."""
    w = sc.PackedNet(nets["dec_math"], nets["dec_dims"])
    d = nets["dec_dims"]
    x = torch.empty(2, d.seq_len * d.cins[0], device="meta")
    emb = torch.empty(2, d.cond_channels * d.emb_dim, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sc.stage_apply(w, 0, x, emb)
    with pytest.raises(ValueError, match="unsupported device"):
        cs.sampler_apply(w, torch.empty(2, 4, device="meta"), None, None, None)


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see the module docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


# float32: same float32 math in another summation order; bfloat16: an fp32
# sum next to a rounding boundary may round one ulp the other way in one of
# the two and move what follows by as much again (4 ulps of the output)
TOLS = {torch.float32: dict(rtol=1e-4, atol=1e-4), torch.bfloat16: dict(rtol=0, atol=2.0 ** -5)}


# float32 full_kernel (the exact bf16 split on the tensor cores) against the
# float32 stage chain (the CUDA cores) on the same operands: its error
# against full_plain within this many times the chain's (chip_smoke.py's
# limit), and the two within SPLIT_VS_CHAIN of max(1, max|ref|) of each
# other (chip_smoke.py reads them 1.7e-6 to 2.7e-6 of it apart on the card;
# tools/kernel_variants.py reads a split that drops the third activation
# part 1.8e-5 to 6.9e-5 of it from full_plain)
SPLIT_VS_CUDA_CORES = 4.0
SPLIT_VS_CHAIN = 5e-6


def _rel(tol, ref):
    return dict(rtol=tol["rtol"], atol=tol["atol"] * max(1.0, ref.float().abs().max().item()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage_and_final_kernels_match_plain_on_card(cuda, nets, dtype):
    d = nets["dec_dims"]
    w = sc.PackedNet(nets["dec_math"], d, dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    BG = 37  # two full row blocks and a ragged edge for every kernel
    emb = torch.randn(BG, d.cond_channels * d.emb_dim, generator=g, device=cuda).to(dtype)
    for i, C in enumerate(d.cins):
        x = torch.randn(BG, d.seq_len * C, generator=g, device=cuda).to(dtype)
        before = sc.STAGE_KERNEL.launches
        got = sc.stage_apply(w, i, x, emb)
        assert sc.STAGE_KERNEL.launches == before + 1
        torch.cuda.synchronize()
        ref = sc.stage_plain(w, i, x, emb)
        torch.testing.assert_close(got.float(), ref.float(), **_rel(TOLS[dtype], ref))
    h = torch.randn(BG, d.seq_len * d.block_channels[-1], generator=g, device=cuda).to(dtype)
    got = sc.final_apply(w, h, emb)
    torch.cuda.synchronize()
    ref = sc.final_plain(w, h, emb)
    torch.testing.assert_close(got.float(), ref.float(), **_rel(TOLS[dtype], ref))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hybrid_kernels_match_plain_on_card(cuda, nets, dtype):
    """``hybrid_stage_kernel`` (each stage, with the previous stage's
    projection from stage 1 on) and ``hybrid_final_kernel`` against their
    plain versions at a ragged BG = 4101, the decoder's L = 16."""
    d = nets["dec_dims"]
    w = sc.PackedNet(nets["dec_math"], d, dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(13)
    BG = 4101
    emb = torch.randn(BG, d.cond_channels * d.emb_dim, generator=g, device=cuda).to(dtype)
    for i in range(len(d.block_channels) + 1):
        x = torch.randn(BG, d.seq_len * d.cins[max(i - 1, 0)], generator=g, device=cuda).to(dtype)
        final = i == len(d.block_channels)
        counter = sc.HYBRID_FINAL_KERNEL if final else sc.HYBRID_STAGE_KERNEL
        before = counter.launches
        got = sc.hybrid_final_apply(w, x, emb) if final else sc.hybrid_stage_apply(w, i, x, emb)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        ref = sc.hybrid_final_plain(w, x, emb) if final else sc.hybrid_stage_plain(w, i, x, emb)
        torch.testing.assert_close(got.float(), ref.float(), **_rel(TOLS[dtype], ref))


@pytest.mark.cuda
@pytest.mark.parametrize("L", [4, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_kernel_matches_plain_and_the_stage_chain_on_card(cuda, nets, dtype, L):
    """``full_kernel`` (one launch) against ``full_plain`` and against the
    chain of 4 ``stage_kernel`` + ``final_kernel`` launches on the same
    operands, at the fpc and ppc denoisers with a ragged row count.
    ``full_kernel`` runs its products on the tensor cores (float32 through
    the exact bf16 split), the chain's float32 stages and its final block on
    the CUDA cores, so the two sum in another order: bf16 within its limit
    of the chain; float32 within ``SPLIT_VS_CUDA_CORES`` of the chain's
    error against ``full_plain``, and within ``SPLIT_VS_CHAIN`` of the
    chain itself (a split that lost float32 precision fails both)."""
    math, dims = nets["den"][L]
    w = sc.PackedNet(math, dims, dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(12)
    BG = 37
    x = torch.randn(BG, dims.seq_len * dims.cins[0], generator=g, device=cuda).to(dtype)
    emb = torch.randn(BG, dims.cond_channels * dims.emb_dim, generator=g, device=cuda).to(dtype)
    before = sc.FULL_KERNEL.launches
    got = sc.full_apply(w, x, emb)
    assert sc.FULL_KERNEL.launches == before + 1
    h = x
    for i in range(len(dims.block_channels)):
        h = sc.stage_apply(w, i, h, emb)
    chain = sc.final_apply(w, h, emb)
    torch.cuda.synchronize()
    ref = sc.full_plain(w, x, emb)
    assert got.shape == (BG, dims.seq_len) and got.dtype == dtype
    torch.testing.assert_close(got.float(), ref.float(), **_rel(TOLS[dtype], ref))
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), chain.float(), **_rel(TOLS[dtype], chain))
        return
    top = max(1.0, ref.abs().max().item())
    err, chain_err = ((t - ref).abs().max().item() for t in (got, chain))
    apart = (got - chain).abs().max().item()
    assert err <= SPLIT_VS_CUDA_CORES * chain_err, (err, chain_err)
    assert apart <= SPLIT_VS_CHAIN * top, apart


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["ddim", "ddpm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sampler_kernel_matches_plain_on_card(cuda, nets, sampler, dtype):
    w = sc.PackedNet(nets["den_math"], FLAGSHIP_DIMS, dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    BG, S = 37, 10
    schedule = DiffusionSchedule.create(num_steps=1000, beta_start=5e-5, beta_end=1e-3)
    z_pc = torch.randn(BG, 3, 64, generator=g, device=cuda)
    embin, trows, coefs = cs.sampler_tables(w, schedule, compute_input_emb(w.aux, z_pc), S,
                                            sampler, "fixed_large")
    x_T = torch.randn(BG, 4, generator=g, device=cuda)
    noise = torch.randn(S, BG, 4, generator=g, device=cuda) if sampler == "ddpm" else None
    before = cs.SAMPLER_KERNEL.launches
    got = cs.sampler_apply(w, x_T, embin, trows, coefs, noise)
    assert cs.SAMPLER_KERNEL.launches == before + 1
    torch.cuda.synchronize()
    ref = cs.sampler_plain(w, x_T, embin, trows, coefs, noise, True, 1.0)
    # x_0 is clipped to [-1, 1]; bf16 rounding flips recur over the steps
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=0, atol=2.0 ** -4)
    torch.testing.assert_close(got, ref, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["ddim", "ddpm"])
@pytest.mark.parametrize("channels", [(8, 16), (16, 32)])
def test_bf16_ddim_sampler_kernel_takes_narrow_models_on_card(cuda, channels, sampler):
    """The tensor-core body of ddim_sampler_kernel<bf16> at widths off its
    16-wide tiles (the init conv's 4 channels, 8-wide stages: zero-padded
    K and N in the fragments, A read value by value) over a ragged BG,
    against its plain version within chip_smoke.TOL_BF16_SAMPLER."""
    torch.manual_seed(1)
    ddm = GraspLatentDDM(block_channels=channels, dropout=None).eval()
    dims = _denoiser_dims(ddm)
    w = sc.PackedNet(pack_math_weights(ddm, dims), dims, torch.bfloat16, cuda)
    g = torch.Generator(device=cuda).manual_seed(7)
    BG, S = 37, 10
    schedule = DiffusionSchedule.create(num_steps=1000, beta_start=5e-5, beta_end=1e-3)
    z_pc = torch.randn(BG, 3, dims.cond_dim, generator=g, device=cuda)
    tables = cs.sampler_tables(w, schedule, compute_input_emb(w.aux, z_pc), S, sampler,
                               "fixed_large")
    x_T = torch.randn(BG, 4, generator=g, device=cuda)
    noise = torch.randn(S, BG, 4, generator=g, device=cuda) if sampler == "ddpm" else None
    got = cs.sampler_apply(w, x_T, *tables, noise)
    torch.cuda.synchronize()
    ref = cs.sampler_plain(w, x_T, *tables, noise, True, 1.0)
    torch.testing.assert_close(got, ref, rtol=0, atol=2.0 ** -4)


# EDM has no clip, so the limits are relative to the output's largest
# magnitude: (largest error, mean error) per number of steps. float32:
# summation order only, as above. bfloat16: chip_smoke.py's limits
# (TOL_BF16_EDM, TOL_BF16_EDM_MEAN over a trajectory, TOL_BF16_EDM_STEP_MEAN
# over 2 steps, where they hold the rounding points), which states why and
# why float32 is not held over 2 steps
EDM_TOLS = {torch.float32: {6: (1e-4, None)},
            torch.bfloat16: {2: (2.0 ** -4, 2.0 ** -10.5), 6: (2.0 ** -4, 2.0 ** -9)}}


@pytest.mark.cuda
@pytest.mark.parametrize("L", [4, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_edm_sampler_kernels_match_plain_on_card(cuda, nets, dtype, L):
    """dpmpp_sampler_kernel and churn_sampler_kernel against their plain
    versions at L = 4 (fpc) and L = 16 (ppc), over a BG that is ragged at
    every block size (16, 9, 4 and 2 rows), for 6 steps and (bf16) 2."""
    math, dims = nets["den"][L]
    w = sc.PackedNet(math, dims, dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    BG, ed = 4101, ElucidatedDiffusion(n_dims=L)
    z_pc = torch.randn(BG, 3, dims.cond_dim, generator=g, device=cuda)
    input_emb = compute_input_emb(w.aux, z_pc)
    x_T = 80.0 * torch.randn(BG, L, generator=g, device=cuda)
    noise = torch.randn(6, BG, L, generator=g, device=cuda)
    for N, (tol, tol_mean) in EDM_TOLS[dtype].items():
        dp = cs.dpmpp_tables(w, ed, input_emb, N)
        ch = cs.churn_tables(w, ed, input_emb, N)
        nz = noise[:N].contiguous()
        runs = [
            (cs.DPMPP_KERNEL, lambda: cs.dpmpp_sampler_apply(w, x_T, *dp),
             lambda: cs.dpmpp_sampler_plain(w, x_T, *dp, False)),
            (cs.CHURN_KERNEL, lambda: cs.churn_sampler_apply(w, x_T, *ch, nz),
             lambda: cs.churn_sampler_plain(w, x_T, *ch, nz, False)),
        ]
        for counter, kernel, plain in runs:
            before = counter.launches
            got = kernel()
            assert counter.launches == before + 1
            torch.cuda.synchronize()
            ref = plain()
            scale = max(1.0, ref.abs().max().item())
            msg = f"{counter.name}, {N} steps"
            torch.testing.assert_close(got, ref, rtol=0, atol=tol * scale, msg=msg)
            if tol_mean is not None:
                mean = (got - ref).abs().mean().item()
                assert mean <= tol_mean * scale, (msg, mean, tol_mean * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ddim_sampler_kernel_matches_plain_at_l16_on_card(cuda, nets, dtype):
    """ddim_sampler_kernel at the ppc denoiser's L = 16 over a ragged BG."""
    math, dims = nets["den"][16]
    w = sc.PackedNet(math, dims, dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(6)
    BG, S = 37, 8
    schedule = DiffusionSchedule.create(num_steps=1000, beta_start=5e-5, beta_end=1e-3)
    z_pc = torch.randn(BG, 3, dims.cond_dim, generator=g, device=cuda)
    embin, trows, coefs = cs.sampler_tables(w, schedule, compute_input_emb(w.aux, z_pc), S,
                                            "ddim", "fixed_large")
    x_T = torch.randn(BG, 16, generator=g, device=cuda)
    got = cs.sampler_apply(w, x_T, embin, trows, coefs)
    torch.cuda.synchronize()
    ref = cs.sampler_plain(w, x_T, embin, trows, coefs, None, True, 1.0)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=0, atol=2.0 ** -4)
    torch.testing.assert_close(got, ref, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [4, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_step_kernels_match_plain_steps_on_card(cuda, nets, dtype, L):
    """ddim_step_kernel (DDIM and DDPM), dpmpp_step_kernel and
    churn_step_kernel against their plain steps at L = 4 (fpc) and 16
    (ppc), over a BG ragged at every block size, 2 chained steps, every
    state held: float32 to 1e-4 of max(1, max|state|); bfloat16 to the
    sampler limits of the tests above (DDIM absolute 2^-4 on clipped
    states; EDM 2^-4 max and 2^-10.5 mean of max|state|, their 2-step
    limits)."""
    math, dims = nets["den"][L]
    w = sc.PackedNet(math, dims, dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(9)
    BG, n = 4101, 2
    for sampler in ("ddim", "ddpm", "dpmpp", "churn"):
        run = _trajectory_run(w, sampler, BG, n, g)
        before = run["counter"].launches
        x0, traj = run["traj"]()
        assert run["counter"].launches == before + n
        torch.cuda.synchronize()
        ref = run["traj_plain"]()
        assert traj.shape[:2] == ref.shape[:2]
        for s in range(ref.shape[0]):
            got, want = traj[s, :, 0], ref[s]
            scale = max(1.0, want.abs().max().item())
            msg = f"{run['counter'].name} {sampler}, state {s}"
            if dtype == torch.float32:
                torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * scale, msg=msg)
            elif sampler in ("ddim", "ddpm"):
                torch.testing.assert_close(got, want, rtol=0, atol=2.0 ** -4, msg=msg)
            else:
                torch.testing.assert_close(got, want, rtol=0, atol=2.0 ** -4 * scale, msg=msg)
                mean = (got - want).abs().mean().item()
                assert mean <= 2.0 ** -10.5 * scale, (msg, mean)


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["ddim", "ddpm", "dpmpp", "churn"])
def test_step_launches_match_whole_trajectory_kernel_on_card(cuda, nets, sampler):
    """S step-kernel launches end where the whole-trajectory kernel does:
    float32, 5 steps, to 1e-4 of max(1, max|x_0|) (the same step body and
    block plan; chip_smoke.py reports whether they are bitwise equal)."""
    math, dims = nets["den"][4]
    w = sc.PackedNet(math, dims, torch.float32, cuda)
    run = _trajectory_run(w, sampler, 37, 5, torch.Generator(device=cuda).manual_seed(10))
    x0, _ = run["traj"]()
    whole = run["whole"]()
    torch.cuda.synchronize()
    scale = max(1.0, whole.abs().max().item())
    torch.testing.assert_close(x0[:, 0], whole, rtol=0, atol=1e-4 * scale)


def _seeded_ldm(device, seed):
    """A reduced flagship (random weights from a seeded generator) and one
    seeded ``ldm_generate`` (DDPM, so the per-step noise is drawn too)."""
    from graspldm_tpu_torch.flagship import FlagshipConfig, build_flagship
    from graspldm_tpu_torch.inference import ldm_generate

    cfg = FlagshipConfig(pc_num_points=64, pc_scale_channels=0.125,
                         pc_scale_voxel_resolution=0.25, block_channels=(16, 32))
    vae, ddm, diff = build_flagship(cfg, generator=torch.Generator().manual_seed(0),
                                    device="cpu")
    pc = torch.randn(2, 64, 3, generator=torch.Generator().manual_seed(1)).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = ldm_generate(vae.to(device), ddm.to(device), diff, pc, 8, gen,
                       num_inference_steps=4, sampler="ddpm")
    return {k: v.cpu() for k, v in out.items()}


def test_generation_is_seeded_by_its_generator():
    """Same seeds -> bitwise-identical grasps; the draws come from the
    caller's generators, not from global RNG state."""
    a, b = _seeded_ldm("cpu", 3), _seeded_ldm("cpu", 3)
    torch.manual_seed(123)  # global state must not matter
    c = _seeded_ldm("cpu", 4)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["grasp_tmrp"], c["grasp_tmrp"])


@pytest.mark.cuda
def test_generation_is_deterministic_on_card(cuda):
    """No float atomics anywhere on the path (voxelization is a one-hot
    product, the kernels own disjoint rows): two runs are bitwise equal."""
    a, b = _seeded_ldm(cuda, 3), _seeded_ldm(cuda, 3)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.cuda
def test_kernel_wrappers_check_their_operands(cuda, nets):
    d = nets["dec_dims"]
    w = sc.PackedNet(nets["dec_math"], d, torch.float32, cuda)
    emb = torch.zeros(4, d.cond_channels * d.emb_dim, device=cuda)
    x = torch.zeros(4, d.seq_len * d.cins[0], device=cuda)
    with pytest.raises(TypeError):
        sc.stage_apply(w, 0, x.to(torch.bfloat16), emb)
    with pytest.raises(ValueError, match="shape"):
        sc.stage_apply(w, 1, x, emb)
    with pytest.raises(ValueError, match="contiguous"):
        sc.stage_apply(w, 0, torch.zeros(x.shape[::-1], device=cuda).t(), emb)


def _fps_clouds(case: str, device) -> tuple:
    g = torch.Generator().manual_seed(11)
    if case == "duplicates":  # every point 4 times: exact ties in every step
        base = torch.randn(16, 256, 3, generator=g)
        c = base.repeat(1, 4, 1)[:, torch.randperm(1024, generator=g)]
        return c.to(device), 256
    if case == "one_point":  # one point 64 times: all distances zero
        return torch.randn(4, 1, 3, generator=g).repeat(1, 64, 1).to(device), 64
    B, N, M = {"m_eq_n": (16, 1024, 1024), "sa1": (16, 1024, 256), "sa2": (16, 256, 64),
               "sa3": (16, 64, 16), "ragged": (5, 1000, 250), "large_n": (2, 8192, 64)}[case]
    return torch.randn(B, N, 3, generator=g).to(device), M


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["m_eq_n", "sa1", "sa2", "sa3", "ragged", "duplicates",
                                  "one_point", "large_n"])
def test_fps_kernel_matches_plain_version_on_card(cuda, case):
    """``fps_kernel`` picks exactly the plain version's indices: ties (to
    the lowest index), M = N, ragged N and the largest N a block holds."""
    coords, M = _fps_clouds(case, cuda)
    before = cuda_fps.FPS_KERNEL.launches
    got = cuda_fps.fps_apply(coords, M)
    torch.cuda.synchronize()
    assert cuda_fps.FPS_KERNEL.launches == before + 1
    assert got.dtype == torch.long and got.shape == (coords.shape[0], M)
    assert torch.equal(got, cuda_fps.fps_plain(coords, M))
    assert torch.equal(got.cpu(), cuda_fps.fps_plain(coords.cpu(), M))


@pytest.mark.cuda
def test_fps_kernel_refuses_a_cloud_larger_than_a_block(cuda):
    with pytest.raises(ValueError, match="8192"):
        cuda_fps.fps_apply(torch.zeros(1, 8193, 3, device=cuda), 4)


@pytest.mark.cuda
def test_packing_follows_the_models_device_on_card(cuda):
    """Models on the card pack on the card with no device named, and
    ``ldm_generate`` takes those weights."""
    from graspldm_tpu_torch.flagship import FlagshipConfig, build_flagship
    from graspldm_tpu_torch.inference import ldm_generate, pack_generation_weights

    cfg = FlagshipConfig(pc_num_points=64, pc_scale_channels=0.125,
                         pc_scale_voxel_resolution=0.25, block_channels=(16, 32))
    vae, ddm, diff = build_flagship(cfg, generator=torch.Generator().manual_seed(0), device=cuda)
    w = pack_generation_weights(vae, ddm)
    for part in (w.decoder, w.denoiser):
        assert part is not None
        assert {t.device.type for t in (part.flat, part.layout, *part.aux.values())} == {"cuda"}
    pc = torch.randn(2, 64, 3, generator=torch.Generator().manual_seed(1)).to(cuda)
    out = ldm_generate(vae, ddm, diff, pc, 8, torch.Generator(device=cuda).manual_seed(2),
                       num_inference_steps=4, weights=w)
    assert out["grasps"].device.type == "cuda" and bool(torch.isfinite(out["grasps"]).all())


# The micro-benchmark kernels against their plain versions on the card, at a
# ragged R and the tools' widths. mm_chain_kernel: float32 within 1e-5 of
# max|ref| (the same exact products, summed in another order: rep by rep in
# the plain version, reps inside the K loop in the kernel). The bf16 chains:
# bitwise, every op being one rounding of the same float32 result in both.
MICROBENCH = [("mm", f) for f in bench_mm.FORMS] + [("silu", f) for f in bench_silu.FORMS] \
    + [("repeat", f) for f in bench_repeat.FORMS]


@pytest.mark.cuda
@pytest.mark.parametrize("tool,form", MICROBENCH)
def test_microbench_kernels_match_plain_on_card(cuda, tool, form):
    R = 1021
    if tool == "mm":
        x, (pf, pb) = bench_mm.make_inputs(R, cuda, 3), bench_mm.make_pool(cuda)
        kern = lambda: bench_mm.mm_chain_apply(x, pf, pb, form)  # noqa: E731
        plain = bench_mm.plain_chain(x, pf, pb, form)
        counter = bench_mm.MM_CHAIN_KERNEL
    elif tool == "silu":
        x = bench_silu.make_inputs(R, 2048, cuda, 3)
        kern = lambda: bench_silu.silu_chain_apply(x, form)  # noqa: E731
        plain, counter = bench_silu.plain_chain(x, form), bench_silu.SILU_CHAIN_KERNEL
    else:
        (s, v), b = bench_repeat.make_inputs(R, cuda, 3), bench_repeat.qbcast(cuda)
        kern = lambda: bench_repeat.bcast_chain_apply(s, v, b, form)  # noqa: E731
        plain = bench_repeat.plain_chain(s, v, b, form)
        counter = bench_repeat.BCAST_CHAIN_KERNEL
    before = counter.launches
    got = kern()
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert got.shape == plain.shape and got.dtype == plain.dtype
    if tool == "mm":
        torch.testing.assert_close(got, plain, rtol=0,
                                   atol=1e-5 * plain.abs().max().item())
    else:
        assert torch.equal(got, plain)


# mm_chain_kernel as a dense product: the tool's one-hot pool weighs 32
# consecutive k rows alike, so a wrong k mapping inside an mma k-step would
# still agree with it; a seeded normal pool (pb = bf16(pf)) tells every k
# apart. Within 2e-4 of max|ref| (chip_smoke.TOL_MM_DENSE, where the reason
# is written): the sums cancel and the kernel adds every rep's products into
# one float32 accumulator an output (read: up to 6.4e-5); a k-mapping fault
# reads about 1.
@pytest.mark.cuda
@pytest.mark.parametrize("R", [8192, 1021])
@pytest.mark.parametrize("form", bench_mm.FORMS)
def test_mm_chain_kernel_dense_pool_on_card(cuda, R, form):
    x = bench_mm.make_inputs(R, cuda, 4)
    pf = torch.randn((bench_mm.K, bench_mm.N), generator=torch.Generator(device=cuda)
                     .manual_seed(5), device=cuda)
    pb = pf.to(torch.bfloat16)
    got = bench_mm.mm_chain_apply(x, pf, pb, form)
    plain = bench_mm.plain_chain(x, pf, pb, form)
    torch.testing.assert_close(got, plain, rtol=0, atol=2e-4 * plain.abs().max().item())


# mm_chain_kernel's f32 form (five exact bf16 products on the tensor cores)
# against the chain in float64 on a dense pool, beside cuBLAS's float32
# products (the plain version, TF32 off) on the same inputs: within
# chip_smoke.TOL_MM_DENSE of max|exact|, as against the plain version.
@pytest.mark.cuda
@pytest.mark.parametrize("R", [8192, 1021])
def test_mm_chain_kernel_f32_against_float64_on_card(cuda, R):
    x = bench_mm.make_inputs(R, cuda, 6)
    pf = torch.randn((bench_mm.K, bench_mm.N), generator=torch.Generator(device=cuda)
                     .manual_seed(7), device=cuda)
    pb = pf.to(torch.bfloat16)
    got = bench_mm.mm_chain_apply(x, pf, pb, "f32")
    cublas = bench_mm.plain_chain(x, pf, pb, "f32")
    exact = bench_mm.REPS * ((x.double() * x.double()) @ pf.double())
    top = exact.abs().max().item()
    err = (got.double() - exact).abs().max().item() / top
    err_cublas = (cublas.double() - exact).abs().max().item() / top
    print(f"R={R}: mm_chain_kernel f32 {err:.3e}, cuBLAS fp32 {err_cublas:.3e} of max|exact|")
    assert err <= 2e-4, (err, err_cublas)
