"""Port parity, the guided and conditioned slice as a whole:
``ldm_generate`` of ``graspldm_tpu_torch`` with class / region conditioning,
classifier-free guidance and success guidance against the JAX package's
``ldm_generate(denoiser_impl="stacked", decoder_impl="flax")`` on the CPU.

The cases: class CFG (DDIM), region CFG (DPM++), success guidance on the
unconditioned flagship (DDPM), CFG and success guidance composed (class,
churn), conditioned without guidance (class DDIM and region DPM++, which
the port runs through its whole-trajectory samplers with the extra
embedding folded in), and two trajectories (class DDIM with CFG, and
unguided: ``return_trajectory``, the unguided one through the port's
per-step sampler wrapper). The JAX package runs its Python-loop samplers
over its stacked XLA denoiser in every case; the port runs its guided loops over
``stacked_denoiser_apply(..., fuse_stages=True)``, i.e. ``full_plain`` on
CPU tensors, and its gradient through its plain decoder.

Cut as ``tests/test_torch_port_pipeline.py`` cuts the flagship: 64-point
clouds, ``pc_scale_channels`` 0.125, ``pc_scale_voxel_resolution`` 0.25,
``block_channels`` (16, 32), B = 2 clouds x G = 4 grasps, 4 sampler steps,
32 region points. Weights are initialised by JAX and carried across by
``graspldm_tpu_torch.utils.convert``; clouds, classes and regions come from
``np.random.default_rng``; x_T and the per-step noise are JAX's own draws.

Tolerance (float32): 5e-4 absolute and relative, the JAX package's sampler
precedent (``tests/test_fused_denoiser.py:322``): PVCNN, the denoiser and
the decoder each reorder sums between XLA and torch, and the steps carry
it (the guidance gradient included).
"""

import numpy as np
import pytest
import torch

import jax

from graspldm_tpu.diffusion import ElucidatedDiffusion as JED
from graspldm_tpu.flagship import FlagshipConfig as JConfig
from graspldm_tpu.flagship import build_flagship as j_build
from graspldm_tpu.inference.pipeline import ldm_generate as j_ldm_generate
from graspldm_tpu.utils.normalization import normalize_pc_and_grasps as j_normalize

from graspldm_tpu_torch.flagship import FlagshipConfig, build_flagship
from graspldm_tpu_torch.inference import ldm_generate
from graspldm_tpu_torch.models import cuda_sampler as cs
from graspldm_tpu_torch.models import stacked_cuda as sc
from graspldm_tpu_torch.utils.convert import (
    class_conditioned_ldm_state_dict,
    grasp_cvae_state_dict,
    grasp_ldm_state_dict,
    region_conditioned_ldm_state_dict,
)
from graspldm_tpu_torch.utils.normalization import normalize_pc_and_grasps

TOL = dict(atol=5e-4, rtol=5e-4)
CFG = dict(pc_num_points=64, pc_scale_channels=0.125, pc_scale_voxel_resolution=0.25,
           block_channels=(16, 32), dropout=None)
B, G, P, STEPS = 2, 4, 32, 4
BG = B * G
KEYS = ("grasps", "grasp_tmrp", "confidence")
CONVERT = {None: grasp_ldm_state_dict, "class": class_conditioned_ldm_state_dict,
           "region": region_conditioned_ldm_state_dict}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module")
def flag():
    """The reduced flagship in both packages: one VAE, and an unconditioned,
    a class- and a region-conditioned denoiser, with DDPM and EDM diffusion."""
    rng = np.random.default_rng(0)
    pc = (rng.normal(0.0, 0.04, size=(B, CFG["pc_num_points"], 3))
          + rng.uniform(-0.5, 0.5, size=(B, 1, 3))).astype(np.float32)
    cls = np.repeat(rng.uniform(0.0, 3.0, size=B).astype(np.float32), G)
    region = np.repeat(rng.normal(0.0, 0.05, size=(B, 1, P, 3)).astype(np.float32)
                       + pc[:, :1, None, :], G, axis=0)[:, 0]
    x = rng.normal(size=(4, 1, 4)).astype(np.float32)
    zc = rng.normal(size=(4, 3, 64)).astype(np.float32)
    cond = {None: {}, "class": dict(cls_cond=cls[:4]), "region": dict(region_points=region[:4])}
    out = dict(pc=pc, cond=dict(cls_cond=cls, region_points=region))
    for kind in (None, "class", "region"):
        jvae, jddm, jdiff = j_build(JConfig(**CFG, conditioning=kind))
        if kind is None:
            out["vv"] = jax.tree.map(np.asarray, jax.jit(jvae.init)(
                jax.random.PRNGKey(0), pc, rng.normal(size=(4, 7)).astype(np.float32)))
            out["jvae"], out["jdiff"] = jvae, jdiff
            out["jed"] = j_build(JConfig(**CFG, elucidated=True))[2]
        dv = jax.tree.map(np.asarray, jax.jit(jddm.init)(
            jax.random.PRNGKey(1), x, np.zeros(4, np.int32), zc, **cond[kind]))
        vae, ddm, diff = build_flagship(FlagshipConfig(**CFG, conditioning=kind), device="cpu")
        ddm.load_state_dict(CONVERT[kind](dv), strict=True)
        out[kind] = dict(jddm=jddm, dv=dv, ddm=ddm)
        if kind is None:
            vae.load_state_dict(grasp_cvae_state_dict(out["vv"]), strict=True)
            out["vae"], out["diff"] = vae, diff
            out["ed"] = build_flagship(FlagshipConfig(**CFG, elucidated=True), device="cpu")[2]
    out["jpc_n"], _, out["jmeta"] = j_normalize(pc, np.zeros((B, 1, 6), np.float32))
    out["pc_n"], _, out["meta"] = normalize_pc_and_grasps(_t(pc), torch.zeros(B, 1, 6))
    return out


def _draws(key, sampler: str, n: int):
    """x_T ``[BG, 4]`` and the per-step noise ``[n, BG, 4]`` as the JAX
    package's Python-loop samplers draw them (``gaussian.py:120-142``,
    ``elucidated.py:163-172``, ``:224-225``)."""
    k_init, k_loop = jax.random.split(key)
    x_T = np.asarray(jax.random.normal(k_init, (BG, 1, 4)))[:, 0]
    if sampler in ("dpmpp", "churn"):
        x_T = np.asarray(JED(n_dims=4).sample_schedule(n))[0] * x_T
    if sampler in ("ddim", "dpmpp"):
        return x_T, None
    noise = []
    for _ in range(n):
        k_loop, k_n = jax.random.split(k_loop)
        noise.append(np.asarray(jax.random.normal(k_n, (BG, 1, 4)))[:, 0])
    return x_T, np.stack(noise)


CASES = {
    "class-cfg-ddim": (
        "class", "ddim", dict(cfg_scale=2.0), False),
    "region-cfg-dpmpp": ("region", "dpmpp", dict(cfg_scale=1.5), False),
    "success-ddpm": (None, "ddpm", dict(guidance_scale=0.5), False),
    "class-cfg-success-churn": ("class", "churn", dict(cfg_scale=2.0, guidance_scale=0.3), False),
    "class-unguided-ddim": ("class", "ddim", {}, False),
    "region-unguided-dpmpp": ("region", "dpmpp", {}, False),
    "class-cfg-ddim-trajectory": ("class", "ddim", dict(cfg_scale=2.0), True),
    "class-unguided-ddim-trajectory": ("class", "ddim", {}, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_guided_ldm_generate_matches_jax(flag, case):
    kind, sampler, guide, traj = CASES[case]
    edm = sampler in ("dpmpp", "churn")
    cond = {} if kind is None else {
        "class": {"cls_cond": flag["cond"]["cls_cond"]},
        "region": {"region_points": flag["cond"]["region_points"]}}[kind]
    key = jax.random.PRNGKey(31)
    m = flag[kind]
    want = j_ldm_generate(flag["jvae"], flag["vv"], m["jddm"], m["dv"],
                          flag["jed"] if edm else flag["jdiff"], flag["jpc_n"], G, key,
                          num_inference_steps=STEPS, sampler=sampler, meta=flag["jmeta"],
                          return_trajectory=traj, denoiser_impl="stacked", decoder_impl="flax",
                          **cond, **guide)
    x_T, noise = _draws(key, sampler, STEPS)
    counts = (sc.FULL_KERNEL.launches, cs.SAMPLER_KERNEL.launches)
    got = ldm_generate(flag["vae"], m["ddm"], flag["ed"] if edm else flag["diff"],
                       flag["pc_n"], G, num_inference_steps=STEPS, sampler=sampler,
                       meta=flag["meta"], x_T=_t(x_T), noise=None if noise is None else _t(noise),
                       return_trajectory=traj, **{k: _t(v) for k, v in cond.items()}, **guide)
    assert (sc.FULL_KERNEL.launches, cs.SAMPLER_KERNEL.launches) == counts  # CPU: no launch
    assert got["grasps"].shape == (B, G, 4, 4)
    keys = KEYS + (("latent_trajectory", "all_diffusion_grasps") if traj else ())
    for k in keys:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), **TOL, err_msg=k)


def test_guided_path_calls_the_whole_network_once_per_evaluation(flag, monkeypatch):
    """On the guided path each denoiser evaluation is one
    ``stacked_denoiser_apply(..., fuse_stages=True)`` call (one
    ``full_kernel`` launch on the card): S per DDIM call, N per DPM++ call,
    2N - 1 per churn call; with CFG each covers 2 BG rows. Unguided
    conditioned calls make none (their extra embedding rides in the
    whole-trajectory sampler's conditioning rows)."""
    from graspldm_tpu_torch.inference import pipeline as pl

    calls = []
    real = pl.stacked_denoiser_apply

    def spy(w, x, *a, **k):
        calls.append((x.shape[0], k.get("fuse_stages")))
        return real(w, x, *a, **k)

    monkeypatch.setattr(pl, "stacked_denoiser_apply", spy)
    cls = {"cls_cond": _t(flag["cond"]["cls_cond"])}
    for sampler, diff, n in (("ddim", flag["diff"], STEPS), ("dpmpp", flag["ed"], STEPS),
                             ("churn", flag["ed"], 2 * STEPS - 1)):
        calls.clear()
        ldm_generate(flag["vae"], flag["class"]["ddm"], diff, flag["pc_n"], G,
                     num_inference_steps=STEPS, sampler=sampler, cfg_scale=2.0, **cls)
        assert calls == [(2 * BG, True)] * n, sampler
    calls.clear()
    ldm_generate(flag["vae"], flag[None]["ddm"], flag["diff"], flag["pc_n"], G,
                 num_inference_steps=STEPS, guidance_scale=1.0)
    assert calls == [(BG, True)] * STEPS
    calls.clear()
    ldm_generate(flag["vae"], flag["class"]["ddm"], flag["diff"], flag["pc_n"], G,
                 num_inference_steps=STEPS, **cls)
    assert calls == []
