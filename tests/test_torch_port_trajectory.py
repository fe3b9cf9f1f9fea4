"""Port parity, trajectories: ``ldm_generate(return_trajectory=True)`` of
``graspldm_tpu_torch`` and the samplers under it against the JAX package on
the CPU.

* The per-step samplers (the plain versions of ``ddim_step_kernel``,
  ``dpmpp_step_kernel`` and ``churn_step_kernel``, looped by
  ``fused_sample*(return_trajectory=True)``) against the JAX package's
  per-step Pallas kernels in interpret mode, both lowerings: the chains
  (``fuse_stages=False``: ``_stage0_*`` -> ``_mid_stage_kernel`` ->
  ``_final_*``) and the one-launch steps (``fuse_stages=True``:
  ``_full_step_kernel``, ``_full_dpmpp_kernel``, ``_full_churn_kernel``),
  at the flagship denoiser's widths (L = 4, channels 32/64/128/256,
  ``z_pc [3, 64]``) and one at the ppc dims (L = 16, ``z_pc [3, 256]``),
  BG = 8 rows, a multiple of ``block_rows`` (JAX draws its noise for the
  padded rows).
* The Python-loop samplers (``GaussianDiffusion1D.sample``,
  ``sample_churn``, ``sample_dpmpp``) and the kernel path against JAX's
  Python-loop samplers over the flax denoiser, including a DDIM / DDPM grid
  that S does not divide.
* ``ldm_generate(return_trajectory=True)`` as a whole, cut as
  ``tests/test_torch_port_pipeline.py`` cuts the flagship (64-point clouds,
  ``block_channels`` (16, 32), B = 2 clouds x G = 4 grasps, 4 steps).
* The decoded states' indices.

Weights are initialised by JAX and carried across by
``graspldm_tpu_torch.utils.convert``; conditioning comes from
``np.random.default_rng``; x_T and the per-step noise are JAX's own draws,
from the same key splits as the function under comparison.

Tolerance (float32): 5e-4 absolute and relative, the JAX package's sampler
precedent (``tests/test_fused_denoiser.py:322``): XLA and torch reorder sums
and every step carries the difference on. Trajectory shapes and decode
indices are held exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graspldm_tpu.diffusion import ElucidatedDiffusion as JED
from graspldm_tpu.diffusion import GaussianDiffusion1D as JGaussian
from graspldm_tpu.diffusion.schedules import DiffusionSchedule as JSchedule
from graspldm_tpu.flagship import FlagshipConfig as JConfig
from graspldm_tpu.flagship import build_flagship as j_build
from graspldm_tpu.inference.pipeline import ldm_generate as j_ldm_generate
from graspldm_tpu.models import GraspLatentDDM as JDDM
from graspldm_tpu.models.fused_denoiser import DenoiserDims as JDims
from graspldm_tpu.models.pallas_sampler import fused_sample as j_fused_sample
from graspldm_tpu.models.pallas_sampler import fused_sample_churn as j_fused_churn
from graspldm_tpu.models.pallas_sampler import fused_sample_dpmpp as j_fused_dpmpp
from graspldm_tpu.models.stacked_denoiser import FLAGSHIP_DIMS as J_DIMS
from graspldm_tpu.models.stacked_denoiser import compute_input_emb as j_input_emb
from graspldm_tpu.models.stacked_pallas import pack_pallas_weights
from graspldm_tpu.utils.normalization import normalize_pc_and_grasps as j_normalize

from graspldm_tpu_torch.diffusion import DiffusionSchedule, ElucidatedDiffusion, GaussianDiffusion1D
from graspldm_tpu_torch.flagship import FlagshipConfig, build_flagship
from graspldm_tpu_torch.inference import ldm_generate, trajectory_decode_indices
from graspldm_tpu_torch.inference.pipeline import _denoiser_dims
from graspldm_tpu_torch.models import GraspLatentDDM
from graspldm_tpu_torch.models.cuda_sampler import (
    fused_sample,
    fused_sample_churn,
    fused_sample_dpmpp,
)
from graspldm_tpu_torch.models.stacked_cuda import PackedNet
from graspldm_tpu_torch.models.stacked_denoiser import compute_input_emb, pack_math_weights
from graspldm_tpu_torch.utils.convert import grasp_cvae_state_dict, grasp_ldm_state_dict
from graspldm_tpu_torch.utils.normalization import normalize_pc_and_grasps

TOL = dict(atol=5e-4, rtol=5e-4)
BG = 8
SCHEDULE = dict(num_steps=1000, beta_start=5e-5, beta_end=1e-3)  # the flagship's
J_DIMS16 = JDims(seq_len=16, block_channels=(32, 64, 128, 256), groups=4, emb_dim=64,
                 cond_channels=3, cond_dim=256, fourier_dim=16)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _net(L: int, cond_dim: int, seed: int):
    """One denoiser at ``L`` / ``cond_dim``: JAX's variables and packed
    Pallas weights, the port's module and packed kernel weights, and
    conditioning for BG rows."""
    rng = np.random.default_rng(seed)
    zc = rng.normal(size=(BG, 3, cond_dim)).astype(np.float32)
    jddm = JDDM(dropout=None, latent_in_features=L, pc_latent_size=cond_dim)
    dv = jax.tree.map(np.asarray, jax.jit(jddm.init)(
        jax.random.PRNGKey(seed + 1), np.zeros((BG, 1, L), np.float32), np.zeros(BG, np.int32),
        zc))
    ddm = GraspLatentDDM(dropout=None, latent_in_features=L, pc_latent_size=cond_dim).eval()
    ddm.load_state_dict(grasp_ldm_state_dict(dv), strict=True)
    dims = _denoiser_dims(ddm)
    packed = PackedNet(pack_math_weights(ddm, dims), dims)
    jw = pack_pallas_weights(dv, J_DIMS if L == 4 else J_DIMS16, dtype=jnp.float32)
    return dict(apply=jax.jit(jddm.apply), dv=dv, ddm=ddm, packed=packed, jw=jw, zc=zc,
                jdims=J_DIMS if L == 4 else J_DIMS16, L=L)


@pytest.fixture(scope="module")
def fpc():
    return _net(4, 64, 0)


@pytest.fixture(scope="module")
def ppc():
    return _net(16, 256, 3)


def _pallas_draws(key, sampler: str, n: int, L: int):
    """x_T and the per-step noise as ``pallas_sampler.py`` draws them for
    BG rows (unpadded: BG is a multiple of ``block_rows``): DDIM / DDPM
    ``:786-787``, ``:931-933``; DPM++ ``:1010-1011``; churn ``:1203-1204``,
    ``:1391-1392``. EDM x_T is at sigma_max scale."""
    k_init, k_loop = jax.random.split(key)
    x_T = np.asarray(jax.random.normal(k_init, (BG, L)))
    if sampler in ("dpmpp", "churn"):
        x_T = np.asarray(JED(n_dims=L).sample_schedule(n))[0] * x_T
    if sampler in ("ddim", "dpmpp"):
        return x_T, None
    noise = []
    for _ in range(n):
        k_loop, k_n = jax.random.split(k_loop)
        noise.append(np.asarray(jax.random.normal(k_n, (BG, L))))
    return x_T, np.stack(noise)


def _port_trajectory(m, sampler: str, n: int, x_T, noise):
    """The port's kernel path with ``return_trajectory`` over ``m``'s plain
    step functions: ``(x_0, trajectory)``."""
    w = m["packed"]
    ie = compute_input_emb(w.aux, _t(m["zc"]))
    nz = None if noise is None else _t(noise)
    if sampler in ("ddim", "ddpm"):
        return fused_sample(w, DiffusionSchedule.create(**SCHEDULE), ie, _t(x_T),
                            num_inference_steps=n, sampler=sampler, noise=nz,
                            return_trajectory=True)
    ed = ElucidatedDiffusion(n_dims=m["L"])
    if sampler == "dpmpp":
        return fused_sample_dpmpp(w, ed, ie, _t(x_T), num_sample_steps=n, return_trajectory=True)
    return fused_sample_churn(w, ed, ie, _t(x_T), num_sample_steps=n, noise=nz,
                              return_trajectory=True)


def _pallas_trajectory(m, sampler: str, n: int, key, fuse_stages):
    jw, dims = m["jw"], m["jdims"]
    ie = j_input_emb(jw, m["zc"])
    kw = dict(batch_size=BG, block_rows=8, interpret=True, return_trajectory=True,
              fuse_stages=fuse_stages)
    if sampler in ("ddim", "ddpm"):
        return j_fused_sample(jw, dims, JSchedule.create(**SCHEDULE), ie, key,
                              num_inference_steps=n, sampler=sampler, **kw)
    fn = j_fused_dpmpp if sampler == "dpmpp" else j_fused_churn
    return fn(jw, dims, JED(n_dims=m["L"]), ie, key, num_sample_steps=n, **kw)


def _hold(got, want) -> None:
    (x0, traj), (jx0, jtraj) = got, want
    assert tuple(traj.shape) == jtraj.shape and tuple(x0.shape) == jx0.shape
    np.testing.assert_allclose(_np(traj), np.asarray(jtraj), **TOL)
    np.testing.assert_allclose(_np(x0), np.asarray(jx0), **TOL)


# ---------------------------------------------------------------------------
# 1. the per-step kernels against both TPU lowerings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fuse_stages", [False, True], ids=["chain", "full"])
@pytest.mark.parametrize("sampler", ["ddim", "ddpm", "dpmpp", "churn"])
def test_step_kernels_match_pallas_per_step_kernels_interpret(fpc, sampler, fuse_stages):
    """fuse_stages=False runs the chains (``_stage0_*`` ->
    ``_mid_stage_kernel`` -> ``_final_*``), True the one-launch
    ``_full_*`` kernels; the port's per-step kernel stands for both.
    Trajectories: DDIM/DDPM ``[S+1]`` and churn ``[N+1]`` with x_T first,
    DPM++ ``[N]`` without it."""
    n, key = 4, jax.random.PRNGKey(21)
    want = _pallas_trajectory(fpc, sampler, n, key, fuse_stages)
    got = _port_trajectory(fpc, sampler, n, *_pallas_draws(key, sampler, n, 4))
    assert got[1].shape[0] == (n if sampler == "dpmpp" else n + 1)
    _hold(got, want)


def test_step_kernel_matches_pallas_at_ppc_dims(ppc):
    """DPM++ at L = 16, ``z_pc [3, 256]``: JAX takes the one-launch
    ``_full_dpmpp_kernel`` there (``fuse_stages`` defaults on at L > 4)."""
    n, key = 3, jax.random.PRNGKey(22)
    want = _pallas_trajectory(ppc, "dpmpp", n, key, None)
    got = _port_trajectory(ppc, "dpmpp", n, *_pallas_draws(key, "dpmpp", n, 16))
    assert got[1].shape == (n, BG, 1, 16)
    _hold(got, want)


# ---------------------------------------------------------------------------
# 2. the Python-loop samplers over the flax denoiser
# ---------------------------------------------------------------------------


def _loop_draws(key, sampler: str, n: int, L: int):
    """x_T and the per-step noise as the JAX package's Python-loop samplers
    draw them, ``[BG, 1, L]`` each (``gaussian.py:120-142``,
    ``elucidated.py:163-172``, ``:224-225``)."""
    k_init, k_loop = jax.random.split(key)
    x_T = np.asarray(jax.random.normal(k_init, (BG, 1, L)))
    if sampler in ("dpmpp", "churn"):
        x_T = np.asarray(JED(n_dims=L).sample_schedule(n))[0] * x_T
    if sampler in ("ddim", "dpmpp"):
        return x_T, None
    noise = []
    for _ in range(n):
        k_loop, k_n = jax.random.split(k_loop)
        noise.append(np.asarray(jax.random.normal(k_n, (BG, 1, L))))
    return x_T, np.stack(noise)


# S = 3 does not divide T = 1000: the grid has 4 steps of stride 333, so
# the trajectory has 5 entries (ROADMAP Faults, second item); the per-step
# tests above run S = 4, which divides it
@pytest.mark.parametrize("sampler,steps", [("ddim", 3), ("ddpm", 3), ("dpmpp", 4), ("churn", 4)])
def test_loop_samplers_return_jax_trajectories(fpc, sampler, steps):
    """``GaussianDiffusion1D.sample`` / ``sample_dpmpp`` / ``sample_churn``
    with ``return_trajectory`` over the port's module, and the kernel path,
    against JAX's samplers over the flax denoiser, fed JAX's own draws."""
    key = jax.random.PRNGKey(23)
    zc, fn = fpc["zc"], (lambda x, t, z: fpc["apply"](fpc["dv"], x, t, z))
    if sampler in ("ddim", "ddpm"):
        jdiff = JGaussian(schedule=JSchedule.create(**SCHEDULE), n_dims=4)
        want = jdiff.sample(fn, key, batch_size=BG, z_cond=zc, num_inference_steps=steps,
                            sampler=sampler, return_trajectory=True)
        diff = GaussianDiffusion1D(schedule=DiffusionSchedule.create(**SCHEDULE), n_dims=4)
        n = len(diff.schedule.timestep_grid(steps))
    else:
        jed = JED(n_dims=4)
        jfn = jed.sample_dpmpp if sampler == "dpmpp" else jed.sample_churn
        want = jfn(fn, key, batch_size=BG, z_cond=zc, num_sample_steps=steps,
                   return_trajectory=True)
        ed, n = ElucidatedDiffusion(n_dims=4), steps
    x_T, noise = _loop_draws(key, sampler, n, 4)
    nz = None if noise is None else _t(noise)
    kw = dict(z_cond=_t(zc), x_T=_t(x_T), return_trajectory=True)
    with torch.no_grad():
        if sampler in ("ddim", "ddpm"):
            loop = diff.sample(fpc["ddm"], BG, num_inference_steps=steps, sampler=sampler,
                               noise=nz, **kw)
        elif sampler == "dpmpp":
            loop = ed.sample_dpmpp(fpc["ddm"], BG, num_sample_steps=steps, **kw)
        else:
            loop = ed.sample_churn(fpc["ddm"], BG, num_sample_steps=steps, noise=nz, **kw)
    expected = n if sampler == "dpmpp" else n + 1
    assert want[1].shape == (expected, BG, 1, 4)
    _hold(loop, want)
    _hold(_port_trajectory(fpc, sampler, steps, x_T[:, 0],
                           None if noise is None else noise[:, :, 0]), want)


# ---------------------------------------------------------------------------
# 3. the whole slice
# ---------------------------------------------------------------------------

CFG = dict(pc_num_points=64, pc_scale_channels=0.125, pc_scale_voxel_resolution=0.25,
           block_channels=(16, 32), dropout=None)
B, G = 2, 4


@pytest.fixture(scope="module")
def flag():
    rng = np.random.default_rng(0)
    jvae, jddm, jdiff = j_build(JConfig(**CFG))
    jed = j_build(JConfig(**CFG, elucidated=True))[2]
    pc = (rng.normal(0.0, 0.04, size=(B, CFG["pc_num_points"], 3))
          + rng.uniform(-0.5, 0.5, size=(B, 1, 3))).astype(np.float32)
    grasps = rng.normal(size=(4, 7)).astype(np.float32)
    vv = jax.tree.map(np.asarray, jax.jit(jvae.init)(jax.random.PRNGKey(0), pc, grasps))
    dv = jax.tree.map(np.asarray, jax.jit(jddm.init)(
        jax.random.PRNGKey(1), rng.normal(size=(4, 1, 4)).astype(np.float32),
        np.zeros(4, np.int32), rng.normal(size=(4, 3, 64)).astype(np.float32)))
    vae, ddm, diff = build_flagship(FlagshipConfig(**CFG), device="cpu")
    vae.load_state_dict(grasp_cvae_state_dict(vv), strict=True)
    ddm.load_state_dict(grasp_ldm_state_dict(dv), strict=True)
    jpc_n, _, jmeta = j_normalize(pc, np.zeros((B, 1, 6), np.float32))
    pc_n, _, meta = normalize_pc_and_grasps(_t(pc), torch.zeros(B, 1, 6))
    return dict(jvae=jvae, jddm=jddm, jdiff=jdiff, jed=jed, vv=vv, dv=dv, vae=vae, ddm=ddm,
                diff=diff, ed=ElucidatedDiffusion(n_dims=4, num_sample_steps=jed.num_sample_steps),
                jpc_n=jpc_n, jmeta=jmeta, pc_n=pc_n, meta=meta)


@pytest.mark.parametrize("sampler", ["ddim", "dpmpp", "churn"])
def test_ldm_generate_trajectory_matches_jax(flag, sampler):
    """``latent_trajectory``, ``all_diffusion_grasps`` and x_0's grasps
    against JAX's ``ldm_generate(return_trajectory=True)``, which takes its
    flax path (the Python-loop samplers) on the CPU."""
    n, key = 4, jax.random.PRNGKey(24)
    edm = sampler != "ddim"
    want = j_ldm_generate(flag["jvae"], flag["vv"], flag["jddm"], flag["dv"],
                          flag["jed"] if edm else flag["jdiff"], flag["jpc_n"], G, key,
                          num_inference_steps=n, sampler=sampler, meta=flag["jmeta"],
                          return_trajectory=True)
    x_T, noise = _loop_draws(key, sampler, n, 4)  # BG = 8 rows = B * G
    got = ldm_generate(flag["vae"], flag["ddm"], flag["ed"] if edm else flag["diff"],
                       flag["pc_n"], G, num_inference_steps=n, sampler=sampler,
                       meta=flag["meta"], x_T=_t(x_T[:, 0]),
                       noise=None if noise is None else _t(noise[:, :, 0]),
                       return_trajectory=True)
    S = n if sampler == "dpmpp" else n + 1
    assert got["latent_trajectory"].shape == want["latent_trajectory"].shape == (S, B * G, 1, 4)
    assert got["all_diffusion_grasps"].shape == want["all_diffusion_grasps"].shape
    assert got["all_diffusion_grasps"].shape == (min(50, S), B, G, 4, 4)
    for k in ("latent_trajectory", "all_diffusion_grasps", "grasps", "grasp_tmrp",
              "confidence"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), **TOL, err_msg=k)


# ---------------------------------------------------------------------------
# 4. which states are decoded
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_states", [3, 5, 33, 51, 101, 201])
def test_decode_indices_match_jax_linspace(n_states):
    """``jnp.linspace(0, S'-1, num=min(50, S')).astype(jnp.int32)``
    (``pipeline.py:605``) exactly, with the last state always decoded."""
    want = np.asarray(jnp.linspace(0, n_states - 1, num=min(50, n_states)).astype(jnp.int32))
    got = trajectory_decode_indices(n_states)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[-1]) == n_states - 1
