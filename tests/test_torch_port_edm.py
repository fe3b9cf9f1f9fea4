"""Port parity, EDM sampling: ``ElucidatedDiffusion``, the DPM-Solver++(2M)
and churn (stochastic Heun) samplers, their kernels' plain versions and
EDM ``ldm_generate`` of ``graspldm_tpu_torch`` against the JAX package on
the CPU.

Two sizes. The denoiser-level tests run the flagship denoiser widths
(L = 4, channels 32/64/128/256, 3 conditioning channels of 64) at BG = 8
rows, as ``tests/test_fused_denoiser.py`` runs its EDM sampler tests. The
end-to-end tests cut the flagship as ``tests/test_torch_port_pipeline.py``
does: 64-point clouds, ``pc_scale_channels`` 0.125,
``pc_scale_voxel_resolution`` 0.25, ``block_channels`` (16, 32), B = 2
clouds x G = 4 grasps.

Weights are initialised by JAX and carried into the port by
``graspldm_tpu_torch.utils.convert``; clouds and conditioning come from
``np.random.default_rng``; x_T and the churn sampler's per-step unit
normals are JAX's own draws, in JAX's key-split order (``elucidated.py``
for the Python-loop samplers, ``pallas_sampler.py`` for the megakernels).
On the CPU every kernel wrapper of the port runs its plain PyTorch version,
which is what these tests hold against the Pallas megakernels in interpret
mode.

Tolerances (float32):
* schedule and preconditioning: 1e-6 relative (the same float32 formulas;
  XLA's and torch's ``log`` / ``rsqrt`` may differ in the last bit), with
  1e-7 absolute where a value is near 0 (``c_noise`` near sigma = 1);
* samplers and ``ldm_generate``: 5e-4 absolute and relative, the JAX
  package's sampler precedent (``tests/test_fused_denoiser.py:322``): XLA
  and torch reorder sums and every step carries the difference on.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graspldm_tpu.diffusion import ElucidatedDiffusion as JED
from graspldm_tpu.flagship import FlagshipConfig as JConfig
from graspldm_tpu.flagship import build_flagship as j_build
from graspldm_tpu.inference.pipeline import ldm_generate as j_ldm_generate
from graspldm_tpu.models import GraspLatentDDM as JDDM
from graspldm_tpu.models.pallas_sampler import fused_sample_churn as j_fused_churn
from graspldm_tpu.models.pallas_sampler import fused_sample_dpmpp as j_fused_dpmpp
from graspldm_tpu.models.stacked_denoiser import FLAGSHIP_DIMS as J_DIMS
from graspldm_tpu.models.stacked_denoiser import compute_input_emb as j_input_emb
from graspldm_tpu.models.stacked_pallas import pack_pallas_weights
from graspldm_tpu.utils.normalization import normalize_pc_and_grasps as j_normalize
from graspldm_tpu.utils.torch_convert import grasp_ldm_variables_from_torch

from graspldm_tpu_torch.diffusion import ElucidatedDiffusion
from graspldm_tpu_torch.flagship import FlagshipConfig, build_flagship
from graspldm_tpu_torch.inference import ldm_generate
from graspldm_tpu_torch.models import GraspLatentDDM
from graspldm_tpu_torch.models.cuda_sampler import fused_sample_churn, fused_sample_dpmpp
from graspldm_tpu_torch.models.stacked_cuda import PackedNet
from graspldm_tpu_torch.models.stacked_denoiser import (
    FLAGSHIP_DIMS,
    compute_input_emb,
    pack_math_weights,
)
from graspldm_tpu_torch.serving import make_batch_generate_from_parts
from graspldm_tpu_torch.utils.convert import grasp_cvae_state_dict, grasp_ldm_state_dict
from graspldm_tpu_torch.utils.normalization import normalize_pc_and_grasps

PRECOND_TOL = dict(rtol=1e-6, atol=1e-7)
SAMPLER_TOL = dict(atol=5e-4, rtol=5e-4)
BG = 8
CFG = dict(pc_num_points=64, pc_scale_channels=0.125, pc_scale_voxel_resolution=0.25,
           block_channels=(16, 32), dropout=None, elucidated=True)
B, G = 2, 4
KEYS = ("grasps", "grasp_tmrp", "confidence")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _loop_draws(key, sampler: str, N: int, shape):
    """x_T (at sigma_max scale) and the churn unit normals as
    ``ElucidatedDiffusion.sample_dpmpp`` / ``sample_churn`` draw them
    (``elucidated.py:163-172``, ``:224-225``)."""
    sigma0 = np.asarray(JED(n_dims=shape[-1]).sample_schedule(N))[0]
    k_init, k_loop = jax.random.split(key)
    x_T = sigma0 * np.asarray(jax.random.normal(k_init, shape))
    if sampler == "dpmpp":
        return x_T, None
    noise = []
    for _ in range(N):
        k_loop, k_eps = jax.random.split(k_loop)
        noise.append(np.asarray(jax.random.normal(k_eps, shape)))
    return x_T, np.stack(noise)


# ---------------------------------------------------------------------------
# 1. schedule and preconditioning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N", [32, 100])
def test_schedule_preconditioning_and_gammas_match_jax(N):
    jed, ed = JED(n_dims=4), ElucidatedDiffusion(n_dims=4)
    assert dataclasses.asdict(ed) == dataclasses.asdict(jed)
    want = np.asarray(jed.sample_schedule(N))
    got = ed.sample_schedule(N)
    assert got.dtype == torch.float32 and got.shape == (N + 1,)
    np.testing.assert_allclose(_np(got), want, **PRECOND_TOL)
    for name in ("c_skip", "c_out", "c_in", "c_noise"):
        np.testing.assert_allclose(
            _np(getattr(ed, name)(_t(want))), np.asarray(getattr(jed, name)(jnp.asarray(want))),
            **PRECOND_TOL, err_msg=name)
    # the churn factors as sample_churn computes them (elucidated.py:157-161)
    jg = jnp.where((want >= jed.S_tmin) & (want <= jed.S_tmax),
                   min(jed.S_churn / N, math.sqrt(2.0) - 1.0), 0.0)
    np.testing.assert_allclose(_np(ed.churn_gammas(_t(want))), np.asarray(jg), **PRECOND_TOL)


def test_schedule_refuses_one_step():
    """Eq. 5 divides by N - 1: JAX's schedule is NaN at N = 1, the port's
    raises instead of sampling from NaN sigmas."""
    assert np.isnan(np.asarray(JED(n_dims=4).sample_schedule(1))[0])
    with pytest.raises(ValueError, match="at least 2 steps"):
        ElucidatedDiffusion(n_dims=4).sample_schedule(1)


# ---------------------------------------------------------------------------
# 2-3. the samplers over the flagship denoiser
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def m():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(BG, 1, 4)).astype(np.float32)
    zc = rng.normal(size=(BG, 3, 64)).astype(np.float32)
    jddm = JDDM(dropout=None)
    dv = jax.tree.map(np.asarray, jax.jit(jddm.init)(
        jax.random.PRNGKey(1), x, np.zeros(BG, np.int32), zc))
    ddm = GraspLatentDDM(dropout=None).eval()
    ddm.load_state_dict(grasp_ldm_state_dict(dv), strict=True)
    packed = PackedNet(pack_math_weights(ddm, FLAGSHIP_DIMS), FLAGSHIP_DIMS)
    return dict(apply=jax.jit(jddm.apply), dv=dv, ddm=ddm, packed=packed, zc=zc)


@pytest.mark.parametrize("N", [3, 8])
@pytest.mark.parametrize("sampler", ["dpmpp", "churn"])
def test_samplers_match_jax_with_flax_denoiser(m, sampler, N):
    """The port's Python-loop ``sample_dpmpp`` / ``sample_churn`` over its
    ``TimeConditionedResNet1D``, and its kernel path (the plain versions of
    ``dpmpp_sampler_kernel`` / ``churn_sampler_kernel``), against JAX's
    ``ElucidatedDiffusion`` samplers over the flax denoiser, fed JAX's own
    draws."""
    jed, ed = JED(n_dims=4), ElucidatedDiffusion(n_dims=4)
    key = jax.random.PRNGKey(11)
    jfn = jed.sample_dpmpp if sampler == "dpmpp" else jed.sample_churn
    want, _ = jfn(lambda x, t, z: m["apply"](m["dv"], x, t, z), key, batch_size=BG,
                  z_cond=m["zc"], num_sample_steps=N)
    want = np.asarray(want)
    x_T, noise = _loop_draws(key, sampler, N, (BG, 1, 4))
    zc = _t(m["zc"])
    with torch.no_grad():
        if sampler == "dpmpp":
            loop = ed.sample_dpmpp(m["ddm"], BG, z_cond=zc, num_sample_steps=N, x_T=_t(x_T))
        else:
            loop = ed.sample_churn(m["ddm"], BG, z_cond=zc, num_sample_steps=N, x_T=_t(x_T),
                                   noise=_t(noise))
    assert loop.shape == (BG, 1, 4)
    np.testing.assert_allclose(_np(loop), want, **SAMPLER_TOL)

    w = m["packed"]
    ie = compute_input_emb(w.aux, zc)
    if sampler == "dpmpp":
        got = fused_sample_dpmpp(w, ed, ie, _t(x_T[:, 0]), num_sample_steps=N)
    else:
        got = fused_sample_churn(w, ed, ie, _t(x_T[:, 0]), num_sample_steps=N,
                                 noise=_t(noise[:, :, 0]))
    assert got.shape == (BG, 1, 4)
    np.testing.assert_allclose(_np(got), want, **SAMPLER_TOL)


@pytest.mark.parametrize("sampler", ["dpmpp", "churn"])
def test_sampler_kernels_match_pallas_megakernels_interpret(m, sampler):
    """The plain versions of the two new kernels against the TPU kernels
    they replace (``pallas_sampler.py:_mega_dpmpp_kernel`` /
    ``_mega_churn_kernel``, whole-scan branch) in interpret mode, over a
    ragged row block: BG = 6 rows in blocks of 4. JAX pads to 8 rows and
    draws each step's churn noise for all 8; the port takes the first 6."""
    bg, N, key = 6, 4, jax.random.PRNGKey(4)
    jed, ed = JED(n_dims=4, num_sample_steps=N), ElucidatedDiffusion(n_dims=4)
    jw = pack_pallas_weights(m["dv"], J_DIMS, dtype=jnp.float32)
    jfn = j_fused_dpmpp if sampler == "dpmpp" else j_fused_churn
    want, _ = jfn(jw, J_DIMS, jed, j_input_emb(jw, m["zc"][:bg]), key, batch_size=bg,
                  num_sample_steps=N, block_rows=4, interpret=True, fuse_scan=True)
    # pallas_sampler.py:1010-1011 / :1203-1204, :1251-1255
    sigma0 = np.asarray(jed.sample_schedule(N))[0]
    k_init, k_loop = jax.random.split(key)
    x_T = sigma0 * np.asarray(jax.random.normal(k_init, (bg, 4)))
    w = m["packed"]
    ie = compute_input_emb(w.aux, _t(m["zc"][:bg]))
    if sampler == "dpmpp":
        got = fused_sample_dpmpp(w, ed, ie, _t(x_T), num_sample_steps=N)
    else:
        noise = []
        for _ in range(N):
            k_loop, k_eps = jax.random.split(k_loop)
            noise.append(np.asarray(jax.random.normal(k_eps, (8, 4)))[:bg])
        got = fused_sample_churn(w, ed, ie, _t(x_T), num_sample_steps=N,
                                 noise=_t(np.stack(noise)))
    np.testing.assert_allclose(_np(got), np.asarray(want), **SAMPLER_TOL)


# ---------------------------------------------------------------------------
# 4-6. the EDM flagship end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flag():
    rng = np.random.default_rng(0)
    jvae, jddm, jdiff = j_build(JConfig(**CFG))
    pc = (rng.normal(0.0, 0.04, size=(B, CFG["pc_num_points"], 3))
          + rng.uniform(-0.5, 0.5, size=(B, 1, 3))).astype(np.float32)
    grasps = rng.normal(size=(4, 7)).astype(np.float32)
    vv = jax.tree.map(np.asarray, jax.jit(jvae.init)(jax.random.PRNGKey(0), pc, grasps))
    x = rng.normal(size=(4, 1, 4)).astype(np.float32)
    zc = rng.normal(size=(4, 3, 64)).astype(np.float32)
    dv = jax.tree.map(np.asarray, jax.jit(jddm.init)(
        jax.random.PRNGKey(1), x, np.zeros(4, np.int32), zc))
    vae, ddm, diff = build_flagship(FlagshipConfig(**CFG), device="cpu")
    vae.load_state_dict(grasp_cvae_state_dict(vv), strict=True)
    ddm.load_state_dict(grasp_ldm_state_dict(dv), strict=True)
    jpc_n, _, jmeta = j_normalize(pc, np.zeros((B, 1, 6), np.float32))
    pc_n, _, meta = normalize_pc_and_grasps(_t(pc), torch.zeros(B, 1, 6))
    return dict(jvae=jvae, jddm=jddm, jdiff=jdiff, vv=vv, dv=dv, vae=vae, ddm=ddm, diff=diff,
                pc=pc, jpc_n=jpc_n, jmeta=jmeta, pc_n=pc_n, meta=meta)


@pytest.mark.parametrize("sampler", ["dpmpp", "churn"])
def test_edm_ldm_generate_matches_jax(flag, sampler):
    N, key = 4, jax.random.PRNGKey(5)
    want = j_ldm_generate(flag["jvae"], flag["vv"], flag["jddm"], flag["dv"], flag["jdiff"],
                          flag["jpc_n"], G, key, num_inference_steps=N, sampler=sampler,
                          meta=flag["jmeta"])
    x_T, noise = _loop_draws(key, sampler, N, (B * G, 1, 4))
    got = ldm_generate(flag["vae"], flag["ddm"], flag["diff"], flag["pc_n"], G,
                       num_inference_steps=N, sampler=sampler, meta=flag["meta"],
                       x_T=_t(x_T[:, 0]), noise=None if noise is None else _t(noise[:, :, 0]))
    assert got["grasps"].shape == (B, G, 4, 4)
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **SAMPLER_TOL, err_msg=k)


def test_edm_flagship_builds_and_its_weights_cross_the_bridge(flag):
    """``FlagshipConfig(elucidated=True)`` builds an ``ElucidatedDiffusion``
    with the JAX package's fields (32 sample steps by default) and the same
    ``GraspLatentDDM`` as the DDIM flagship, so the EDM flagship's JAX
    variables load into the port's denoiser (strictly, in the fixture) and
    convert back bit for bit."""
    diff = build_flagship(FlagshipConfig(elucidated=True, block_channels=(8, 16),
                                         pc_num_points=32, pc_scale_channels=0.125,
                                         pc_scale_voxel_resolution=0.25), device="cpu")[2]
    assert isinstance(diff, ElucidatedDiffusion) and diff.num_sample_steps == 32
    assert dataclasses.asdict(flag["diff"]) == dataclasses.asdict(flag["jdiff"])
    sd = {k: v.numpy() for k, v in flag["ddm"].state_dict().items()}
    back = grasp_ldm_variables_from_torch(sd, num_blocks=len(CFG["block_channels"]))
    flat_a, tree_a = jax.tree.flatten(back)
    flat_b, tree_b = jax.tree.flatten(flag["dv"])
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("sampler", ["dpmpp", "churn"])
def test_edm_batch_generate_answers_a_batch(flag, sampler):
    """The server's compute callable over the EDM flagship, on the CPU."""
    fn = make_batch_generate_from_parts(flag["vae"], flag["ddm"], flag["diff"], device="cpu",
                                        num_grasps=G, num_inference_steps=4, sampler=sampler)
    out = fn(flag["pc"] + np.float32(3.0), None)
    assert out["grasps"].shape == (B, G, 4, 4) and np.isfinite(out["grasps"]).all()
    assert out["grasp_tmrp"].shape == (B, G, 6)
    conf = out["confidence"]
    assert conf.shape == (B, G) and ((conf > 0) & (conf < 1)).all()
    R = out["grasps"][..., :3, :3]
    np.testing.assert_allclose(R @ np.swapaxes(R, -1, -2), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-5)


@pytest.mark.parametrize("option", [dict(cfg_scale=2.0)])
@pytest.mark.parametrize("sampler", ["dpmpp", "churn"])
def test_edm_unported_options_raise(flag, sampler, option):
    """What the unconditioned EDM flagship refuses: classifier-free
    guidance needs a conditioned denoiser (``ValueError``, as the JAX
    package). EDM guidance itself is ported (``guidance_fn`` shifts every
    estimate, ``tests/test_torch_port_guidance.py``)."""
    with pytest.raises(ValueError, match="conditioned denoiser"):
        ldm_generate(flag["vae"], flag["ddm"], flag["diff"], flag["pc_n"], G,
                     num_inference_steps=2, sampler=sampler, **option)
    fn = flag["diff"].sample_dpmpp if sampler == "dpmpp" else flag["diff"].sample_churn
    x = fn(lambda x, t, z: x, 2, num_sample_steps=2, guidance_fn=lambda x: x)
    assert x.shape == (2, 1, 4) and bool(torch.isfinite(x).all())
