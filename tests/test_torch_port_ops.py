"""Port parity, part 1: rotations, normalization, schedules, 1-D layers and
voxel ops of ``graspldm_tpu_torch`` against the JAX package on the CPU.

Inputs come from ``np.random.default_rng``; flax layers are initialised by
JAX and their variables carried into the torch modules by the weight bridge
(``graspldm_tpu_torch.utils.convert``). Everything is float32.

Tolerances: where both sides do the same float32 operations in the same
order the comparison is near-exact (1e-6); where the two frameworks lower a
convolution, reduction or einsum differently, the sums are reordered and the
JAX package's own precedent for such comparisons applies (atol 1e-4 /
rtol 5e-4, ``tests/test_fused_denoiser.py:39``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graspldm_tpu.diffusion.schedules import DiffusionSchedule as JSchedule
from graspldm_tpu.models import layers as jl
from graspldm_tpu.ops import voxel as jvox
from graspldm_tpu.utils import normalization as jnorm
from graspldm_tpu.utils import rotations as jrot

from graspldm_tpu_torch.diffusion import DiffusionSchedule
from graspldm_tpu_torch.models import layers as tl
from graspldm_tpu_torch.ops import voxel as tvox
from graspldm_tpu_torch.utils import convert
from graspldm_tpu_torch.utils import normalization as tnorm
from graspldm_tpu_torch.utils import rotations as trot

EXACT = dict(atol=1e-6, rtol=1e-6)
REORDERED = dict(atol=1e-4, rtol=5e-4)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module: torch.nn.Module, fill) -> torch.nn.Module:
    """Fill a state dict with a convert helper under a dummy prefix."""
    sd = {}
    fill(sd)
    sd = {k.split(".", 1)[1] if k.startswith("m.") else k: v for k, v in sd.items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


# ---------------------------------------------------------------------------
# rotations and normalization
# ---------------------------------------------------------------------------


def test_tmrp_to_H_matches_jax():
    rng = np.random.default_rng(0)
    tmrp = rng.normal(size=(3, 5, 6)).astype(np.float32)
    np.testing.assert_allclose(
        _np(trot.mrp_to_rotmat(_t(tmrp[..., 3:]))),
        np.asarray(jrot.mrp_to_rotmat(tmrp[..., 3:])), **EXACT)
    got = _np(trot.tmrp_to_H(_t(tmrp)))
    np.testing.assert_allclose(got, np.asarray(jrot.tmrp_to_H(tmrp)), **EXACT)
    R = got[..., :3, :3].astype(np.float64)
    np.testing.assert_allclose(R @ np.swapaxes(R, -1, -2), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-5)


def test_normalization_round_trip_matches_jax():
    rng = np.random.default_rng(1)
    pc = rng.normal(0.2, 0.05, size=(2, 32, 3)).astype(np.float32)
    grasps = rng.normal(size=(2, 7, 7)).astype(np.float32)
    pc_n, g_n, meta = tnorm.normalize_pc_and_grasps(_t(pc), _t(grasps))
    jpc_n, jg_n, jmeta = jnorm.normalize_pc_and_grasps(pc, grasps)
    np.testing.assert_allclose(_np(pc_n), np.asarray(jpc_n), **EXACT)
    np.testing.assert_allclose(_np(g_n), np.asarray(jg_n), **EXACT)
    for a, b in zip(meta, jmeta):
        np.testing.assert_allclose(_np(a), np.asarray(b), **EXACT)
    back = tnorm.unnormalize_grasps(g_n[..., :6], meta)
    np.testing.assert_allclose(
        _np(back), np.asarray(jnorm.unnormalize_grasps(jg_n[..., :6], jmeta)), **EXACT)
    np.testing.assert_allclose(_np(back), grasps[..., :6], atol=1e-5)


# ---------------------------------------------------------------------------
# diffusion schedule
# ---------------------------------------------------------------------------


def test_schedule_tables_match_jax():
    kw = dict(num_steps=1000, beta_start=5e-5, beta_end=1e-3)
    ts_, js = DiffusionSchedule.create(**kw), JSchedule.create(**kw)
    assert ts_.alphas_cumprod.dtype == torch.float32
    # both float32; linspace and cumprod round differently in the last
    # place, which a 1000-term product accumulates to a few ulps of 1.0
    np.testing.assert_allclose(_np(ts_.alphas_cumprod), np.asarray(js.alphas_cumprod),
                               atol=2e-6, rtol=0)
    for S in (1, 7, 100, 1000):
        np.testing.assert_array_equal(_np(ts_.timestep_grid(S)),
                                      np.asarray(js.timestep_grid(S)))


@pytest.mark.parametrize("variance_type", ["fixed_large", "fixed_small"])
def test_ddim_ddpm_steps_match_jax(variance_type):
    kw = dict(num_steps=100, beta_start=1e-4, beta_end=0.02)
    ts_, js = DiffusionSchedule.create(**kw), JSchedule.create(**kw)
    rng = np.random.default_rng(2)
    x, eps, noise = (rng.normal(size=(4, 1, 4)).astype(np.float32) for _ in range(3))
    # the last grid step has prev_t < 0 (acp_prev = 1, no DDPM noise)
    for t, prev in ((99, 89), (50, 40), (9, -1), (0, -10)):
        np.testing.assert_allclose(
            _np(ts_.ddim_step(_t(x), _t(eps), t, prev)),
            np.asarray(js.ddim_step(x, eps, t, prev)), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(
            _np(ts_.ddpm_step(_t(x), _t(eps), t, prev, _t(noise), variance_type)),
            np.asarray(js.ddpm_step(x, eps, t, prev, noise, variance_type)),
            atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# 1-D layers (JAX [B, L, C] vs torch [B, C, L])
# ---------------------------------------------------------------------------


def _bcl(a: np.ndarray) -> torch.Tensor:
    return _t(np.swapaxes(a, 1, 2))


def _blc(t: torch.Tensor) -> np.ndarray:
    return np.swapaxes(_np(t), 1, 2)


def test_ws_conv_uses_biased_variance_like_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, 8)).astype(np.float32)
    m = jl.WSConv1d(12)
    v = _to_np(m.init(jax.random.PRNGKey(0), x))
    tm = _load(tl.WSConv1d(8, 12, 3, padding=1),
               lambda sd: convert._conv1d(sd, "m", v["params"]))
    with torch.no_grad():
        got = _blc(tm(_bcl(x)))
    np.testing.assert_allclose(got, np.asarray(m.apply(v, x)), **REORDERED)


def test_channel_layer_norm_and_fourier_features_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5, 24)).astype(np.float32)
    m = jl.ChannelLayerNorm()
    v = _to_np(m.init(jax.random.PRNGKey(0), x))
    v["params"]["g"] = rng.normal(size=24).astype(np.float32)
    tm = tl.ChannelLayerNorm(24)
    tm.load_state_dict({"g": convert._gain(v["params"]["g"])})
    np.testing.assert_allclose(_blc(tm(_bcl(x))), np.asarray(m.apply(v, x)), atol=1e-5,
                               rtol=1e-5)

    t = np.array([0, 3, 250, 999], np.int32)
    pe = jl.RandomOrLearnedSinusoidalPosEmb(16)
    pv = _to_np(pe.init(jax.random.PRNGKey(1), t))
    tpe = tl.RandomOrLearnedSinusoidalPosEmb(16)
    assert "weights" in dict(tpe.named_buffers())  # frozen, like flax's constants
    tpe.load_state_dict({"weights": _t(pv["constants"]["weights"])})
    # sin/cos of arguments up to ~1e4 rad: float32 argument rounding (~5e-4
    # rad) is the same on both sides, the libm sin/cos differ by an ulp
    np.testing.assert_allclose(_np(tpe(torch.from_numpy(t))), np.asarray(pe.apply(pv, t)),
                               atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("ndim", [2, 3])
def test_film_scale_shift_matches_jax(ndim):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6, 8)).astype(np.float32)
    shape = (2, 8) if ndim == 2 else (2, 3, 8)
    scale, shift = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    want = np.asarray(jl.film_scale_shift(x, scale, shift))
    got = _blc(tl.film_scale_shift(_bcl(x), _t(scale), _t(shift)))
    np.testing.assert_allclose(got, want, **EXACT)


@pytest.mark.parametrize("cin,cout", [(16, 16), (8, 16)])
def test_resnet_block_matches_jax(cin, cout):
    """Multi-channel FiLM conditioning, two SiLUs on the embedding path,
    and the 1x1 residual conv when the width changes."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 16, cin)).astype(np.float32)
    emb = rng.normal(size=(3, 3, 64)).astype(np.float32)
    m = jl.ResnetBlock1D(cout, groups=4)
    v = _to_np(m.init(jax.random.PRNGKey(2), x, emb))
    tm = _load(tl.ResnetBlock1D(cin, cout, 64, groups=4),
               lambda sd: convert._resblock(sd, "", v["params"]))
    with torch.no_grad():
        got = _blc(tm(_bcl(x), _t(emb)))
    np.testing.assert_allclose(got, np.asarray(m.apply(v, x, emb)), **REORDERED)


def test_linear_attention_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 16, 32)).astype(np.float32)
    m = jl.LinearAttention1D()
    v = _to_np(m.init(jax.random.PRNGKey(3), x))
    p = v["params"]

    def fill(sd):
        convert._conv1x1(sd, "to_qkv", p["to_qkv"])
        convert._conv1x1(sd, "to_out.0", p["to_out"])
        sd["to_out.1.g"] = convert._gain(p["out_norm"]["g"])

    tm = _load(tl.LinearAttention1D(32), fill)
    with torch.no_grad():
        got = _blc(tm(_bcl(x)))
    np.testing.assert_allclose(got, np.asarray(m.apply(v, x)), **REORDERED)


# ---------------------------------------------------------------------------
# voxel ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("normalize", [False, True])
def test_voxel_ops_match_jax(normalize):
    rng = np.random.default_rng(8)
    r = 6
    coords = rng.normal(0.0, 0.4, size=(2, 50, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 50, 5)).astype(np.float32)
    vox = _np(tvox.normalize_coords_for_voxelization(_t(coords), r, normalize=normalize))
    np.testing.assert_allclose(
        vox, np.asarray(jvox.normalize_coords_for_voxelization(coords, r, normalize=normalize)),
        **EXACT)
    grid = tvox.avg_voxelize(_t(feats), _t(vox), r)
    jgrid = np.asarray(jvox.avg_voxelize(feats, vox, r))
    np.testing.assert_allclose(_np(grid), jgrid, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        _np(tvox.trilinear_devoxelize(grid, _t(vox), r)),
        np.asarray(jvox.trilinear_devoxelize(jgrid, vox, r)), atol=1e-5, rtol=1e-5)


def test_avg_voxelize_rounds_half_to_even_and_averages():
    # coords exactly on .5 go to the even voxel (jnp.round == torch.round)
    vox = np.array([[[0.5, 0.0, 0.0], [1.5, 0.0, 0.0], [2.5, 0.0, 0.0], [0.4, 0.0, 0.0]]],
                   np.float32)
    feats = np.array([[[1.0], [2.0], [4.0], [8.0]]], np.float32)
    got = _np(tvox.avg_voxelize(_t(feats), _t(vox), 3))
    np.testing.assert_array_equal(got, np.asarray(jvox.avg_voxelize(feats, vox, 3)))
    # voxel 0 <- {0.5, 0.4}: (1 + 8) / 2; voxel 2*9 <- {1.5, 2.5}: (2 + 4) / 2
    assert got[0, 0, 0] == 4.5 and got[0, 18, 0] == 3.0
    assert np.count_nonzero(got) == 2
