"""Port parity, the whole slice: ``ldm_generate`` / ``vae_generate`` of
``graspldm_tpu_torch`` against the JAX package's on the CPU, and the port's
HTTP server answering requests.

Cut to size (the flagship's shapes, fewer and narrower layers): 64-point
clouds, ``pc_scale_channels`` 0.125 and ``pc_scale_voxel_resolution`` 0.25
(PVCNN channels 8/16/128/256, voxel grids 8^3 and 4^3), ``block_channels``
(16, 32) for the denoiser and the decoder, B = 2 clouds x G = 4 grasps,
5 sampler steps. The latent sizes (grasp 4, ``z_pc`` [3, 64]), the decoder's
L = 16 and the linear-beta schedule are the flagship's.

Weights are initialised by JAX and carried across by
``graspldm_tpu_torch.utils.convert``; clouds come from
``np.random.default_rng``, and the latents x_T / z_h and the DDPM noise are
JAX's own draws from the same key. On the CPU the port runs the kernels'
plain versions; the JAX package picks its flax path there.

Tolerance (float32): 5e-4 absolute and relative, the JAX package's sampler
precedent (``tests/test_fused_denoiser.py:322``): PVCNN, the denoiser and the
decoder each reorder sums between XLA and torch, and the steps carry it.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from graspldm_tpu.flagship import FlagshipConfig as JConfig
from graspldm_tpu.flagship import build_flagship as j_build
from graspldm_tpu.inference.pipeline import ldm_generate as j_ldm_generate
from graspldm_tpu.inference.pipeline import vae_generate as j_vae_generate
from graspldm_tpu.utils.normalization import normalize_pc_and_grasps as j_normalize

from graspldm_tpu_torch.flagship import FlagshipConfig, build_flagship
from graspldm_tpu_torch.inference import ldm_generate, vae_generate
from graspldm_tpu_torch.serving import DynamicBatcher, GraspServer, make_batch_generate_from_parts
from graspldm_tpu_torch.utils.convert import grasp_cvae_state_dict, grasp_ldm_state_dict
from graspldm_tpu_torch.utils.normalization import normalize_pc_and_grasps

TOL = dict(atol=5e-4, rtol=5e-4)
CFG = dict(pc_num_points=64, pc_scale_channels=0.125, pc_scale_voxel_resolution=0.25,
           block_channels=(16, 32), dropout=None)
B, G, STEPS = 2, 4, 5
KEYS = ("grasps", "grasp_tmrp", "confidence")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _jax_draws(key, sampler: str, n_steps: int, bg: int, d: int):
    """x_T and the DDPM noise as ``GaussianDiffusion1D.sample`` draws them."""
    k_init, k_loop = jax.random.split(key)
    x_T = np.asarray(jax.random.normal(k_init, (bg, 1, d)))[:, 0]
    if sampler == "ddim":
        return x_T, None
    noise = []
    for _ in range(n_steps):
        k_loop, k_noise = jax.random.split(k_loop)
        noise.append(np.asarray(jax.random.normal(k_noise, (bg, 1, d)))[:, 0])
    return x_T, np.stack(noise)


@pytest.fixture(scope="module")
def m():
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


def _check(got, want):
    assert got["grasps"].shape == (B, G, 4, 4)
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL, err_msg=k)


@pytest.mark.parametrize("sampler", ["ddim", "ddpm"])
def test_ldm_generate_matches_jax(m, sampler):
    key = jax.random.PRNGKey(5)
    want = j_ldm_generate(m["jvae"], m["vv"], m["jddm"], m["dv"], m["jdiff"], m["jpc_n"], G,
                          key, num_inference_steps=STEPS, sampler=sampler, meta=m["jmeta"])
    x_T, noise = _jax_draws(key, sampler, STEPS, B * G, 4)
    got = ldm_generate(m["vae"], m["ddm"], m["diff"], m["pc_n"], G,
                       num_inference_steps=STEPS, sampler=sampler, meta=m["meta"],
                       x_T=_t(x_T), noise=None if noise is None else _t(noise))
    _check(got, want)


def test_vae_generate_matches_jax(m):
    key = jax.random.PRNGKey(6)
    want = j_vae_generate(m["jvae"], m["vv"], m["jpc_n"], G, key, meta=m["jmeta"])
    z_h = np.asarray(jax.random.normal(key, (B * G, 4)))
    got = vae_generate(m["vae"], m["pc_n"], G, meta=m["meta"], z_h=_t(z_h))
    _check(got, want)


@pytest.mark.parametrize("option", [
    dict(cfg_scale=2.0), dict(cfg_scale=2.0, guidance_scale=1.0),
    dict(cls_cond=torch.zeros(B * G)), dict(region_points=torch.zeros(B * G, 8, 3)),
])
def test_unported_generation_options_raise(m, option):
    """What the unconditioned flagship refuses, as the JAX package does
    (``pipeline.py:_resolve_denoiser_impl``, ``_make_cfg_denoise_fn``):
    classifier-free guidance needs a conditioned denoiser, and this one
    takes no class or region. (Conditioning and guidance are ported:
    ``tests/test_torch_port_guided_generate.py``.)"""
    with pytest.raises(ValueError):
        ldm_generate(m["vae"], m["ddm"], m["diff"], m["pc_n"], G, num_inference_steps=2,
                     **option)


def test_edm_sampler_needs_elucidated_diffusion(m):
    """"dpmpp" / "churn" are EDM samplers: with a GaussianDiffusion1D they
    are refused, as the JAX package's ``GaussianDiffusion1D.sample`` does."""
    for sampler in ("dpmpp", "churn"):
        with pytest.raises(ValueError, match="ElucidatedDiffusion"):
            ldm_generate(m["vae"], m["ddm"], m["diff"], m["pc_n"], G, num_inference_steps=2,
                         sampler=sampler)


@pytest.mark.parametrize("option", [dict(conditioning="region", cond_dropout=0.1),
                                    dict(conditioning="text")])
def test_unported_flagship_options_raise(option):
    """What ``build_flagship`` still refuses: conditioning dropout is a
    training option, and the config has no such field until training is
    ported; a conditioning other than None / "class" / "region" is unknown.
    (The conditioned flagships are ported: ``tests/test_torch_port_guidance.py``.)"""
    with pytest.raises(TypeError if "cond_dropout" in option else ValueError):
        build_flagship(FlagshipConfig(**option), device="cpu")


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_answers_generate_requests(m):
    """``GraspServer`` + ``DynamicBatcher`` over the port's LDM pipeline on
    an ephemeral localhost port: concurrent requests of different sizes are
    batched and answered in the reference schema, in the world frame of each
    request's cloud (per-object centering runs in the request path); bad
    requests get 400."""
    fn = make_batch_generate_from_parts(m["vae"], m["ddm"], m["diff"], device="cpu",
                                        num_grasps=G, num_inference_steps=STEPS, seed=0)
    batcher = DynamicBatcher(fn, num_points=CFG["pc_num_points"], max_batch=2,
                             max_wait_ms=200.0, requires_cls=False)
    server = GraspServer(batcher, host="127.0.0.1", port=0, info={"num_grasps": G})
    server.start_background()
    try:
        host, port = server.address[:2]
        url = f"http://{host}:{port}/v1/generate"
        rng = np.random.default_rng(7)
        # metric clouds far from the origin and from each other
        centres = [np.array([3.0, -2.0, 1.0]), np.array([-4.0, 0.5, 2.0])]
        bodies = [
            {"points": (c + rng.normal(0.0, 0.03, size=(n, 3))).tolist(), "num_grasps": g}
            for c, n, g in zip(centres, (100, 40), (G, 2))
        ]
        results = [None, None]

        def call(i):
            results[i] = _post(url, bodies[i])

        threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
        for (status, body), c, req in zip(results, centres, bodies):
            assert status == 200, body
            g = req["num_grasps"]
            assert body["num_grasps"] == g
            H = np.asarray(body["grasps"])
            assert H.shape == (g, 4, 4) and np.isfinite(H).all()
            assert np.asarray(body["grasp_tmrp"]).shape == (g, 6)
            conf = np.asarray(body["confidence"])
            assert conf.shape == (g,) and ((conf > 0) & (conf < 1)).all()
            np.testing.assert_array_equal(H[:, 3], np.broadcast_to([0, 0, 0, 1.0], (g, 4)))
            R = H[:, :3, :3]
            np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape),
                                       atol=1e-5)
            # translations are O(1) normalized units x 0.05 m about the centroid
            assert np.abs(H[:, :3, 3] - c).max() < 1.0

        assert _post(url, {"points": [[0.0, 0.0]], "num_grasps": 1})[0] == 400
        assert _post(url, {"points": [[0.0, 0.0, 0.0]], "num_grasps": G + 1})[0] == 400
        assert _post(url, {"points": [[0.0, 0.0, 0.0]], "cls": 1.0})[0] == 400
        assert batcher.stats()["errors"] == 0
    finally:
        server.shutdown()
