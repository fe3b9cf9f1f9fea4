"""The port's kernel wrappers and its JAX-free import surface.

This file imports torch and numpy only (no JAX), so the ``cuda`` tests run
on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_port_kernels.py

Without a card they skip. The other tests run anywhere: a CPU tensor takes
each wrapper's plain PyTorch version and counts no launch, and a tensor on
any other device is refused rather than quietly computed elsewhere.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from graspldm_tpu_torch.diffusion import DiffusionSchedule
from graspldm_tpu_torch.models import GraspCVAE, GraspLatentDDM
from graspldm_tpu_torch.models import cuda_sampler as cs
from graspldm_tpu_torch.models import stacked_cuda as sc
from graspldm_tpu_torch.models.fast_decoder import decoder_dims_for
from graspldm_tpu_torch.models.stacked_denoiser import (
    FLAGSHIP_DIMS,
    compute_input_emb,
    pack_math_weights,
)

REPO = Path(__file__).resolve().parents[1]


def _counts():
    return (sc.STAGE_KERNEL.launches, sc.FINAL_KERNEL.launches, cs.SAMPLER_KERNEL.launches)


@pytest.fixture(scope="module")
def nets():
    torch.manual_seed(0)
    vae = GraspCVAE(dropout=None, pc_num_points=32, pc_scale_channels=0.25,
                    pc_scale_voxel_resolution=0.25).eval()
    ddm = GraspLatentDDM(dropout=None).eval()
    ddims = decoder_dims_for(vae)
    return dict(dec_math=pack_math_weights(vae.decoder.net, ddims), dec_dims=ddims,
                den_math=pack_math_weights(ddm, FLAGSHIP_DIMS))


def test_port_never_imports_jax():
    """Every module of the port imports without loading jax or flax (the
    card's machine has neither)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import graspldm_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'graspldm_tpu'))\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 20, mods\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


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
    assert _counts() == before


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


def _seeded_ldm(device, seed):
    """A reduced flagship (random weights from a seeded generator) and one
    seeded ``ldm_generate`` (DDPM, so the per-step noise is drawn too)."""
    from graspldm_tpu_torch.flagship import FlagshipConfig, build_flagship
    from graspldm_tpu_torch.inference import ldm_generate

    cfg = FlagshipConfig(pc_num_points=64, pc_scale_channels=0.125,
                         pc_scale_voxel_resolution=0.25, block_channels=(16, 32))
    vae, ddm, diff = build_flagship(cfg, generator=torch.Generator().manual_seed(0))
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
