"""Port parity: ``ElucidatedDiffusion.sample``, the entry point that picks
DPM-Solver++(2M) (``use_dpmpp=True``) or the stochastic churn sampler, in
the JAX package's argument order.

Two holds, on the CPU. Against the port's own samplers: ``sample`` returns
bitwise what ``sample_churn`` / ``sample_dpmpp`` return on the same draws,
whether they are injected (``x_T``, ``noise``) or come from a seeded
``torch.Generator``. Against the JAX package: ``sample`` over the port's
``TimeConditionedResNet1D`` at the flagship denoiser's widths (L = 4,
channels 32/64/128/256, 3 conditioning channels of 64) at BG = 8 rows,
against JAX's ``ElucidatedDiffusion.sample`` over the flax denoiser with the
same weights, fed JAX's own draws, at the loop samplers' tolerance of
``tests/test_torch_port_edm.py`` (5e-4 absolute and relative: XLA and torch
reorder float32 sums and every step carries the difference on).
"""

import numpy as np
import pytest
import torch

import jax

from graspldm_tpu.diffusion import ElucidatedDiffusion as JED
from graspldm_tpu.models import GraspLatentDDM as JDDM

from graspldm_tpu_torch.diffusion import ElucidatedDiffusion
from graspldm_tpu_torch.models import GraspLatentDDM
from graspldm_tpu_torch.utils.convert import grasp_ldm_state_dict

SAMPLER_TOL = dict(atol=5e-4, rtol=5e-4)
BG, N = 8, 4
SAMPLERS = {"churn": False, "dpmpp": True}


def _draws(key, use_dpmpp: bool, shape):
    """x_T (at sigma_max scale) and the churn unit normals as the JAX
    package's ``sample_churn`` / ``sample_dpmpp`` draw them from ``key``
    (``elucidated.py:163-172``, ``:224-225``); DPM++ draws no noise."""
    sigma0 = np.asarray(JED(n_dims=shape[-1]).sample_schedule(N))[0]
    k_init, k_loop = jax.random.split(key)
    x_T = sigma0 * np.asarray(jax.random.normal(k_init, shape))
    if use_dpmpp:
        return x_T, None
    noise = []
    for _ in range(N):
        k_loop, k_eps = jax.random.split(k_loop)
        noise.append(np.asarray(jax.random.normal(k_eps, shape)))
    return x_T, np.stack(noise)


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
    apply = jax.jit(jddm.apply)
    return dict(jax_net=lambda x_, t, z: apply(dv, x_, t, z), ddm=ddm, zc=zc)


def _injected(use_dpmpp: bool, seed: int = 3):
    """x_T and (churn) the unit normals from numpy, as tensors."""
    g = np.random.default_rng(seed)
    x_T = torch.from_numpy(80.0 * g.normal(size=(BG, 1, 4)).astype(np.float32))
    noise = None if use_dpmpp else torch.from_numpy(
        g.normal(size=(N, BG, 1, 4)).astype(np.float32))
    return x_T, noise


def _same(a, b) -> None:
    """Bitwise equal results: a tensor, or the (x_0, trajectory) pair."""
    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert u.shape == v.shape and torch.equal(u, v)


@pytest.mark.parametrize("return_trajectory", [False, True])
@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_sample_is_the_chosen_sampler_with_injected_draws(m, sampler, return_trajectory):
    ed, use_dpmpp = ElucidatedDiffusion(n_dims=4), SAMPLERS[sampler]
    x_T, noise = _injected(use_dpmpp)
    zc = torch.from_numpy(m["zc"])
    kw = dict(z_cond=zc, num_sample_steps=N, return_trajectory=return_trajectory, x_T=x_T)
    with torch.no_grad():
        got = ed.sample(m["ddm"], BG, use_dpmpp=use_dpmpp, noise=noise, **kw)
        want = (ed.sample_dpmpp(m["ddm"], BG, **kw) if use_dpmpp else
                ed.sample_churn(m["ddm"], BG, noise=noise, **kw))
    _same(got, want)
    if return_trajectory:
        assert got[1].shape[0] == (N if use_dpmpp else N + 1)


@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_sample_draws_from_the_generator_as_the_sampler_does(m, sampler):
    """No draws given: ``sample`` and the sampler it picks take the same
    numbers from generators of the same seed."""
    ed, use_dpmpp = ElucidatedDiffusion(n_dims=4), SAMPLERS[sampler]
    zc = torch.from_numpy(m["zc"])
    with torch.no_grad():
        got = ed.sample(m["ddm"], BG, zc, N, use_dpmpp,
                        generator=torch.Generator().manual_seed(7))
        fn = ed.sample_dpmpp if use_dpmpp else ed.sample_churn
        want = fn(m["ddm"], BG, zc, N, generator=torch.Generator().manual_seed(7))
    _same(got, want)


def test_sample_passes_guidance_and_clamp_through(m):
    ed = ElucidatedDiffusion(n_dims=4)
    x_T, noise = _injected(False)
    zc = torch.from_numpy(m["zc"])
    kw = dict(clamp=True, guidance_fn=lambda d: -0.5 * d, guidance_scale=0.25, x_T=x_T)
    with torch.no_grad():
        got = ed.sample(m["ddm"], BG, zc, N, noise=noise, **kw)
        want = ed.sample_churn(m["ddm"], BG, zc, N, noise=noise, **kw)
        plain = ed.sample_churn(m["ddm"], BG, zc, N, noise=noise, x_T=x_T)
    _same(got, want)
    assert not torch.equal(got, plain)


def test_sample_refuses_noise_for_dpmpp(m):
    ed = ElucidatedDiffusion(n_dims=4)
    x_T, noise = _injected(False)
    with pytest.raises(ValueError, match="takes no noise"):
        ed.sample(m["ddm"], BG, torch.from_numpy(m["zc"]), N, use_dpmpp=True, x_T=x_T,
                  noise=noise)


@pytest.mark.parametrize("return_trajectory", [False, True])
@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_sample_matches_jax_sample(m, sampler, return_trajectory):
    use_dpmpp = SAMPLERS[sampler]
    key = jax.random.PRNGKey(11)
    want_x, want_traj = JED(n_dims=4).sample(
        m["jax_net"], key, BG, m["zc"], num_sample_steps=N, use_dpmpp=use_dpmpp,
        return_trajectory=return_trajectory)
    x_T, noise = _draws(key, use_dpmpp, (BG, 1, 4))
    with torch.no_grad():
        got = ElucidatedDiffusion(n_dims=4).sample(
            m["ddm"], BG, torch.from_numpy(m["zc"]), N, use_dpmpp,
            return_trajectory=return_trajectory, x_T=torch.from_numpy(x_T),
            noise=None if noise is None else torch.from_numpy(noise))
    got_x, got_traj = got if return_trajectory else (got, None)
    assert got_x.shape == (BG, 1, 4)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), **SAMPLER_TOL)
    if return_trajectory:
        assert got_traj.shape == want_traj.shape
        np.testing.assert_allclose(got_traj.numpy(), np.asarray(want_traj), **SAMPLER_TOL)
    else:
        assert want_traj is None
