"""GroupNorm as one pass in the float32 tensor-core network bodies.

Where a float32 resblock's products run on the tensor cores
(``csrc/tc_blocks.cuh``), each of its GroupNorms is one pass of a warp a
(row, group): the warp sums the group's values and their squared deviations
in ``group_stats``' order, then applies the norm (with FiLM and SiLU, or as
the output pass) to the same values (``csrc/resnet1d_blocks.cuh``:
``gn_pass``), with the bits of the two passes that the bf16 and CUDA-core
bodies keep. The CPU test holds ``tools/kernel_variants.py``'s variants
against today's sources; the card tests hold the kernels against their
plain versions and their determinism.

This file imports torch and numpy only (no JAX), so the ``cuda`` tests run
on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_port_groupnorm.py

Without a card they skip.
"""

from __future__ import annotations

import pytest
import torch

from graspldm_tpu_torch.diffusion import DiffusionSchedule, ElucidatedDiffusion
from graspldm_tpu_torch.inference.pipeline import _denoiser_dims
from graspldm_tpu_torch.models import GraspCVAE, GraspLatentDDM
from graspldm_tpu_torch.models import cuda_sampler as cs
from graspldm_tpu_torch.models import stacked_cuda as sc
from graspldm_tpu_torch.models.fast_decoder import decoder_dims_for
from graspldm_tpu_torch.models.stacked_denoiser import compute_input_emb, pack_math_weights

F32, BF16 = torch.float32, torch.bfloat16
# the fpc (latent 4, L = 4) and ppc (latent 16, L = 16) denoisers
CONFIGS = {"fpc": dict(latent_in_features=4, pc_latent_size=64),
           "ppc": dict(latent_in_features=16, pc_latent_size=256)}
def _denoiser(config: str, dtype, channels=(32, 64, 128, 256), device="cpu") -> sc.PackedNet:
    torch.manual_seed(0)
    ddm = GraspLatentDDM(block_channels=channels, dropout=None, **CONFIGS[config]).eval()
    dims = _denoiser_dims(ddm)
    return sc.PackedNet(pack_math_weights(ddm, dims), dims, dtype, device)


def _decoder(dtype, device="cpu", **kw) -> sc.PackedNet:
    torch.manual_seed(0)
    vae = GraspCVAE(dropout=None, pc_num_points=32, pc_scale_channels=0.25,
                    pc_scale_voxel_resolution=0.25, **kw).eval()
    dims = decoder_dims_for(vae)
    return sc.PackedNet(pack_math_weights(vae.decoder.net, dims), dims, dtype, device)


def _variants():
    from graspldm_tpu_torch.tools import kernel_variants as kv

    return list(kv.VARIANTS) + ["--staging counter"]


@pytest.mark.parametrize("name", _variants())
def test_kernel_variants_patches_apply(name):
    """Each variant of ``tools/kernel_variants.py`` (GroupNorm's two passes
    again, its one pass's loops rolled, bf16 in one pass, among them) and
    its ``--staging`` counter still patch today's sources: each text once."""
    from graspldm_tpu_torch.tools import kernel_variants as kv

    kv.patched_sources(kv._STAGING if name == "--staging counter" else kv.VARIANTS[name])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see the module docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


# the limits of the card tests beside these (tests/test_torch_port_split.py,
# test_torch_port_kernels.py), relative to max(1, max|ref|): a network
# evaluation; and a 10-step sampler's x_0, as test_sampler_kernel_matches_
# plain_on_card holds it (absolute; x_0 is clipped to [-1, 1])
TOL = {F32: 1e-4, BF16: 2.0 ** -5}
SAMPLER_TOL = {F32: dict(rtol=1e-4, atol=1e-4), BF16: dict(rtol=0, atol=2.0 ** -4)}
# fpc BG 4096, ppc 1024 (the cells' sampler launches, a quarter of a call)
# and a ragged 1021
SHAPES = [("fpc", 4096), ("ppc", 1024), ("fpc", 1021), ("ppc", 1021)]


def _close(got, ref, tol) -> float:
    assert bool(torch.isfinite(got.float()).all())
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * max(1.0, ref.float().abs().max().item()), err
    return err


def _twice(call):
    """Two launches on the same operands: no atomics, a fixed order of
    every sum, so the bits are the same."""
    a = call()
    b = call()
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("config,BG", SHAPES)
def test_fused_full_kernel_matches_plain_on_card(cuda, config, BG, dtype):
    """``full_kernel`` against ``full_plain``, twice with the same bits."""
    w = _denoiser(config, dtype, device=cuda)
    d = w.dims
    g = torch.Generator(device=cuda).manual_seed(31)
    x = torch.randn(BG, d.seq_len * d.cins[0], generator=g, device=cuda).to(dtype)
    emb = torch.randn(BG, d.cond_channels * d.emb_dim, generator=g, device=cuda).to(dtype)
    got = _twice(lambda: sc.full_apply(w, x, emb))
    _close(got, sc.full_plain(w, x, emb), TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("config,BG", SHAPES)
def test_fused_sampler_kernels_match_plain_on_card(cuda, config, BG, dtype):
    """``ddim_sampler_kernel`` over 10 steps (both dtypes) and the float32
    ``dpmpp_sampler_kernel`` over 8 against their plain versions, each twice
    with the same bits."""
    w = _denoiser(config, dtype, device=cuda)
    d = w.dims
    g = torch.Generator(device=cuda).manual_seed(32)
    z = torch.randn(BG, d.cond_channels, d.cond_dim, generator=g, device=cuda)
    sched = DiffusionSchedule.create(num_steps=1000, beta_start=5e-5, beta_end=1e-3)
    embin, trows, coefs = cs.sampler_tables(w, sched, compute_input_emb(w.aux, z), 10, "ddim",
                                            "fixed_large")
    x_T = torch.randn(BG, d.seq_len, generator=g, device=cuda)
    got = _twice(lambda: cs.sampler_apply(w, x_T, embin, trows, coefs))
    ref = cs.sampler_plain(w, x_T, embin, trows, coefs, None, True, 1.0)
    torch.testing.assert_close(got, ref, **SAMPLER_TOL[dtype])
    if dtype == BF16:
        return
    ed = ElucidatedDiffusion(n_dims=d.seq_len)
    dp = cs.dpmpp_tables(w, ed, compute_input_emb(w.aux, z), 8)
    x_T = ed.sigma_max * x_T
    got = _twice(lambda: cs.dpmpp_sampler_apply(w, x_T, *dp))
    _close(got, cs.dpmpp_sampler_plain(w, x_T, *dp, False), TOL[F32])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("BG", [4096, 1021])
def test_fused_decoder_kernels_match_plain_on_card(cuda, BG, dtype):
    """The decoder's 4 ``stage_kernel`` launches and ``final_kernel`` (L =
    16) against ``stage_plain`` / ``final_plain``, each twice with the same
    bits."""
    w = _decoder(dtype, device=cuda)
    d = w.dims
    g = torch.Generator(device=cuda).manual_seed(33)
    emb = torch.randn(BG, d.cond_channels * d.emb_dim, generator=g, device=cuda).to(dtype)
    for i, C in enumerate(d.cins):
        x = torch.randn(BG, d.seq_len * C, generator=g, device=cuda).to(dtype)
        got = _twice(lambda: sc.stage_apply(w, i, x, emb))
        _close(got, sc.stage_plain(w, i, x, emb), TOL[dtype])
    x = torch.randn(BG, d.seq_len * d.block_channels[-1], generator=g, device=cuda).to(dtype)
    got = _twice(lambda: sc.final_apply(w, x, emb))
    _close(got, sc.final_plain(w, x, emb), TOL[dtype])
