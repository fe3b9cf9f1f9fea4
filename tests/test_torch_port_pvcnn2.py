"""Port parity, PVCNN2: the point-cloud ops (FPS, gather, ball query,
grouping, 3-NN) and the PVCNN2 encoder family of ``graspldm_tpu_torch``
against the JAX package on the CPU.

Inputs come from ``np.random.default_rng``; flax modules are initialised by
JAX, their BatchNorm statistics and norm affines redrawn (so BatchNorm is
not the identity), and the variables carried into the torch modules by the
weight bridge (``graspldm_tpu_torch.utils.convert``). Everything is float32
and on the CPU, where ``furthest_point_sample`` runs its plain version.

Tolerances: every selection (FPS, ball query, the 3-NN picks) is held to
exactly JAX's indices, FPS also against the Pallas kernel in interpret
mode; the gathers are exact; distances and the 3-NN interpolation 1e-6
(float32 sums of three terms in another order); the modules 1e-4 of the
output's largest magnitude (convolutions and BatchNorm lowered differently
by the two frameworks, through up to 8 stages).

Sizes are small (64-point clouds, the tiny SA/FP spec of
``tests/test_extras.py``), with one case at the real SA shapes
(N = 1024 -> M = 1024 and 256) for the ops alone.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graspldm_tpu.models import pvcnn as jpv
from graspldm_tpu.models import pvcnn2 as jpv2
from graspldm_tpu.ops import neighborhood as jnb
from graspldm_tpu.ops import sampling as jsamp
from graspldm_tpu.ops.pallas_fps import furthest_point_sample_pallas

from graspldm_tpu_torch.models import pvcnn as tpv
from graspldm_tpu_torch.models import pvcnn2 as tpv2
from graspldm_tpu_torch.ops import (
    ball_query,
    furthest_point_sample,
    gather_points,
    group_points,
    pairwise_sq_dists,
    three_nn_interpolate,
)
from graspldm_tpu_torch.ops.cuda_fps import FPS_KERNEL
from graspldm_tpu_torch.utils import convert

DIST = dict(atol=1e-6, rtol=1e-6)
MODULE_REL = 1e-4
TINY_SA = (
    ((8, 1, 4), (32, 0.2, 8, (8, 16))),
    (None, (8, 0.4, 8, (16, 32))),
)
TINY_FP = (
    ((16, 16), (16, 1, 4)),
    ((16, 8), (8, 1, 4)),
)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _cloud(rng, B: int, N: int, scale: float = 0.3) -> np.ndarray:
    return (rng.normal(0.0, scale, size=(B, N, 3))).astype(np.float32)


def _redraw(variables, seed: int):
    """Numpy variables with BatchNorm running statistics and every norm's
    scale and bias drawn from ``seed`` (flax initialises them to the
    identity)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == "mean" or (name == "bias" and path[-2].key.startswith(("bn_", "voxel_norm"))):
            return rng.normal(0.0, 0.1, size=a.shape).astype(np.float32)
        if name == "var" or name == "scale":
            return rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)
        return np.asarray(a)

    return jax.tree_util.tree_map_with_path(leaf, jax.tree.map(np.asarray, variables))


def _init(module, seed: int, *args):
    key = jax.random.PRNGKey(seed)
    return _redraw(jax.jit(module.init)({"params": key, "dropout": key}, *args), seed)


def _close(got: torch.Tensor, want, rel: float = MODULE_REL) -> float:
    want = np.asarray(want)
    assert got.shape == want.shape, (tuple(got.shape), want.shape)
    err = np.abs(_np(got) - want).max() / max(np.abs(want).max(), 1e-30)
    assert np.isfinite(_np(got)).all() and err <= rel, err
    return err


# ---------------------------------------------------------------------------
# furthest point sampling
# ---------------------------------------------------------------------------


def _fps_input(case: str, rng) -> tuple:
    if case == "duplicates":  # every point twice, shuffled: exact ties everywhere
        base = _cloud(rng, 2, 32)
        c = np.concatenate([base, base], axis=1)
        return c[:, rng.permutation(64)], 40
    if case == "one_point_repeated":  # all distances zero after the first pick
        return np.repeat(_cloud(rng, 2, 1), 16, axis=1), 8
    B, N, M = {"small": (2, 64, 16), "m_eq_n": (2, 48, 48), "ragged": (3, 100, 25),
               "sa_1024": (1, 1024, 1024), "sa_256": (2, 1024, 256)}[case]
    return _cloud(rng, B, N), M


@pytest.mark.parametrize("case", ["small", "duplicates", "one_point_repeated", "m_eq_n",
                                  "ragged", "sa_1024", "sa_256"])
def test_fps_matches_jax_op_and_pallas_kernel(case):
    """The port's FPS (its plain version on the CPU) gives exactly the JAX
    op's indices and the Pallas kernel's (interpret mode), ties included;
    no kernel launch is counted for a CPU tensor."""
    rng = np.random.default_rng(0)
    coords, M = _fps_input(case, rng)
    want = np.asarray(jsamp.furthest_point_sample(jnp.asarray(coords), M))
    pallas = np.asarray(furthest_point_sample_pallas(jnp.asarray(coords), M, interpret=True))
    before = FPS_KERNEL.launches
    got = furthest_point_sample(_t(coords), M)
    assert FPS_KERNEL.launches == before
    assert got.dtype == torch.long and got.shape == (coords.shape[0], M)
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(got), pallas)
    picked = gather_points(_t(coords), got)
    np.testing.assert_array_equal(_np(picked), np.asarray(jsamp.gather_points(coords, want)))


def test_fps_refuses_bad_shapes():
    with pytest.raises(ValueError, match=r"\[B, N, 3\]"):
        furthest_point_sample(torch.zeros(2, 8, 2), 4)
    with pytest.raises(ValueError, match="num_samples"):
        furthest_point_sample(torch.zeros(2, 8, 3), 0)
    with pytest.raises(ValueError, match="unsupported device"):
        furthest_point_sample(torch.zeros(2, 8, 3, device="meta"), 4)


# ---------------------------------------------------------------------------
# ball query, grouping, 3-NN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,M,N,radius,U", [(2, 18, 64, 0.3, 8), (1, 256, 1024, 0.2, 32),
                                            (1, 1024, 1024, 0.1, 32)])
def test_ball_query_dense_and_blocked_match_jax(B, M, N, radius, U):
    """First U neighbours in index order, padded with the first found, 0
    when none is found (the far centres), dense and M-blocked."""
    rng = np.random.default_rng(1)
    points = _cloud(rng, B, N)
    centers = points[:, rng.choice(N, M, replace=False)] + rng.normal(
        0.0, 0.05, size=(B, M, 3)).astype(np.float32)
    centers[:, :2] += 10.0  # no neighbour at all
    want = np.asarray(jnb.ball_query(centers, points, radius, U))
    dense = ball_query(_t(centers), _t(points), radius, U)
    assert dense.dtype == torch.long
    np.testing.assert_array_equal(_np(dense), want)
    assert (want[:, :2] == 0).all()
    blocked = ball_query(_t(centers), _t(points), radius, U, block_size=4)
    np.testing.assert_array_equal(_np(blocked), want)
    np.testing.assert_array_equal(
        _np(blocked), np.asarray(jnb.ball_query(centers, points, radius, U, block_size=4)))


def test_ball_query_squares_the_radius_in_float32():
    """A point at squared distance float32(0.01) from the centre lies inside
    radius 0.1 as JAX squares it (float32(0.1)**2 = 0.010000001), outside
    if the square were rounded from float64 (float32(0.01))."""
    points = np.array([[[1.0, 1.0, 1.0], [0.075478464, 0.065597266, 0.0]]], np.float32)
    centers = np.zeros((1, 1, 3), np.float32)
    want = np.asarray(jnb.ball_query(centers, points, 0.1, 2))
    np.testing.assert_array_equal(want, [[[1, 1]]])
    np.testing.assert_array_equal(_np(ball_query(_t(centers), _t(points), 0.1, 2)), want)


def test_group_points_and_distances_match_jax():
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(2, 64, 5)).astype(np.float32)
    idx = rng.integers(0, 64, size=(2, 16, 8))
    np.testing.assert_array_equal(_np(group_points(_t(feats), _t(idx))),
                                  np.asarray(jnb.group_points(feats, idx.astype(np.int32))))
    a, b = _cloud(rng, 2, 16), _cloud(rng, 2, 64)
    np.testing.assert_allclose(_np(pairwise_sq_dists(_t(a), _t(b))),
                               np.asarray(jnb.pairwise_sq_dists(a, b)), **DIST)


def test_three_nn_interpolate_matches_jax():
    """Includes points that coincide with centres (distance clamped to
    1e-10) and duplicated centres (ties: the lower index first)."""
    rng = np.random.default_rng(3)
    centers = _cloud(rng, 2, 16)
    centers[:, 5] = centers[:, 4]
    points = np.concatenate([_cloud(rng, 2, 60), centers[:, :4]], axis=1)
    feats = rng.normal(size=(2, 16, 6)).astype(np.float32)
    want = np.asarray(jnb.three_nn_interpolate(points, centers, feats))
    np.testing.assert_allclose(_np(three_nn_interpolate(_t(points), _t(centers), _t(feats))),
                               want, **DIST)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def _load(module: torch.nn.Module, fill) -> torch.nn.Module:
    sd = {}
    fill(sd)
    module.load_state_dict(sd, strict=True)
    return module.eval()


def test_pvconv_normalized_with_se_relu_matches_jax():
    rng = np.random.default_rng(4)
    xyz = _cloud(rng, 2, 64)
    feats = rng.normal(size=(2, 64, 5)).astype(np.float32)
    jm = jpv.PVConv(out_channels=8, resolution=4, with_se_relu=True, normalize=True)
    v = _init(jm, 4, feats, xyz)
    want = jm.apply(v, feats, xyz)
    tm = _load(tpv.PVConv(5, 8, 4, normalize=True, with_se_relu=True),
               lambda sd: convert._pvconv(sd, "", v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = tm(_t(feats).transpose(1, 2), _t(xyz).transpose(1, 2)).transpose(1, 2)
    _close(got, want)


@pytest.mark.parametrize("kind", ["ssg", "msg", "global"])
def test_sa_modules_match_jax(kind):
    rng = np.random.default_rng(5)
    xyz = _cloud(rng, 2, 64)
    feats = rng.normal(size=(2, 64, 4)).astype(np.float32)
    if kind == "ssg":
        jm = jpv2.PointNetSAModule(num_centers=16, radius=0.3, num_neighbors=8,
                                   mlp_channels=(8, 16))
        tm = tpv2.PointNetSAModule(4, 16, 0.3, 8, (8, 16))
        mlps = ["mlp"]
    elif kind == "msg":
        jm = jpv2.PointNetMSGSAModule(num_centers=16, radii=(0.2, 0.4), num_neighbors=(4, 8),
                                      mlp_channels=((8,), (8, 12)))
        tm = tpv2.PointNetMSGSAModule(4, 16, (0.2, 0.4), (4, 8), ((8,), (8, 12)))
        mlps = ["mlp_0", "mlp_1"]
    else:
        jm = jpv2.PointNetAModule(mlp_channels=((8, 16), (12,)))
        tm = tpv2.PointNetAModule(4, ((8, 16), (12,)))
        mlps = ["mlp_0", "mlp_1"]
    v = _init(jm, 5, feats, xyz)
    want_f, want_c = jm.apply(v, feats, xyz)

    def fill(sd):
        for j, name in enumerate(mlps):
            convert._shared_mlp(sd, f"mlps.{j}.", v["params"][name], v["batch_stats"][name])

    tm = _load(tm, fill)
    with torch.no_grad():
        got_f, got_c = tm(_t(feats).transpose(1, 2), _t(xyz).transpose(1, 2))
    np.testing.assert_array_equal(_np(got_c.transpose(1, 2)), np.asarray(want_c))
    _close(got_f.transpose(1, 2), want_f)


@pytest.mark.parametrize("n_centers", [16, 1])
def test_fp_module_matches_jax(n_centers):
    """3-NN interpolation + skip + MLP; one centre is repeated to three."""
    rng = np.random.default_rng(6)
    pts, ctr = _cloud(rng, 2, 64), _cloud(rng, 2, n_centers)
    cf = rng.normal(size=(2, n_centers, 6)).astype(np.float32)
    pf = rng.normal(size=(2, 64, 3)).astype(np.float32)
    jm = jpv2.PointNetFPModule(mlp_channels=(8, 4))
    v = _init(jm, 6, pts, ctr, cf, pf)
    want = jm.apply(v, pts, ctr, cf, pf)
    tm = _load(tpv2.PointNetFPModule(9, (8, 4)),
               lambda sd: convert._shared_mlp(sd, "mlp.", v["params"]["mlp"],
                                              v["batch_stats"]["mlp"]))
    with torch.no_grad():
        got = tm(*(_t(a).transpose(1, 2) for a in (pts, ctr, cf, pf)))
    _close(got.transpose(1, 2), want)


def test_pvcnn2_matches_jax():
    rng = np.random.default_rng(7)
    xyz = _cloud(rng, 2, 64)
    jm = jpv2.PVCNN2(sa_blocks=TINY_SA, fp_blocks=TINY_FP)
    v = _init(jm, 7, xyz)
    want = jm.apply(v, xyz)
    tm = tpv2.PVCNN2(sa_blocks=TINY_SA, fp_blocks=TINY_FP)
    tm.load_state_dict(convert.pvcnn2_state_dict(v), strict=True)
    with torch.no_grad():
        got = tm.eval()(_t(xyz).transpose(1, 2))
    assert tm.out_channels == 8
    _close(got.transpose(1, 2), want)


class _TinyPVCNN2(jpv2.PVCNN2):
    sa_blocks: tuple = TINY_SA
    fp_blocks: tuple = TINY_FP


def test_pvcnn2_encoder_matches_jax(monkeypatch):
    """The encoder head over the tiny backbone (both encoders build their
    backbone by name, so the tiny spec is patched in there)."""
    monkeypatch.setattr(jpv2, "PVCNN2", _TinyPVCNN2)
    monkeypatch.setattr(tpv2, "PVCNN2", functools.partial(tpv2.PVCNN2, sa_blocks=TINY_SA,
                                                          fp_blocks=TINY_FP))
    rng = np.random.default_rng(8)
    xyz = _cloud(rng, 2, 64)
    jm = jpv2.PVCNN2Encoder(out_features=12, n_points=64)
    v = _init(jm, 8, xyz)
    want = jm.apply(v, xyz)
    tm = tpv2.PVCNN2Encoder(out_features=12, n_points=64)
    tm.load_state_dict(convert.pvcnn2_encoder_state_dict(v), strict=True)
    with torch.no_grad():
        got = tm.eval()(_t(xyz))
    assert got.shape == (2, 12)
    _close(got, want)


@pytest.mark.parametrize("kind", ["ssg", "msg"])
def test_pointnet2_matches_jax(kind):
    """Tiny specs of the SSG and MSG layouts (a global stage last, so the
    first FP stage interpolates from one centre)."""
    ssg = ((24, 0.3, 8, (8, 16)), (8, 0.5, 8, (16, 16, 24)), (None, None, None, (16, 32)))
    msg = ((24, (0.2, 0.4), (4, 8), ((8,), (8, 12))), (8, (0.4, 0.8), (4, 8), ((12,), (16,))),
           (None, None, None, (16, 32)))
    sa = ssg if kind == "ssg" else msg
    fp = ((16, 16), (16,), (8, 8))
    rng = np.random.default_rng(9)
    feats = np.concatenate([_cloud(rng, 2, 64), rng.normal(size=(2, 64, 3))], -1).astype(
        np.float32)
    jm = jpv2.PointNet2(sa_blocks=sa, fp_blocks=fp)
    v = _init(jm, 9, feats)
    want = jm.apply(v, feats)
    tm = tpv2.PointNet2(sa_blocks=sa, fp_blocks=fp)
    tm.load_state_dict(convert.pointnet2_state_dict(v), strict=True)
    with torch.no_grad():
        got = tm.eval()(_t(feats).transpose(1, 2))
    _close(got.transpose(1, 2), want)


def test_pointnet2_presets_build():
    """The SSG / MSG presets build with JAX's published channel widths."""
    assert tpv2.PointNet2SSG().out_channels == 128
    msg = tpv2.PointNet2MSG()
    assert msg.sa_layers[0].out_channels == 64 + 128 + 128 and msg.out_channels == 128
