"""Port parity, attention between launches: the hybrid route of
``graspldm_tpu_torch`` (``stacked_cuda.XLA_ATTENTION`` at L > 4) against the
JAX package's (``stacked_pallas.XLA_ATTENTION``) on the CPU.

Both flags are patched as a user would set them (``mock.patch.object``;
nothing in the JAX package is edited). JAX reads its flag when it packs
(``pack_pallas_weights``) and when it applies, so both happen under the
patch. What is held:

* ``stacked_denoiser_apply`` (on CPU tensors: ``hybrid_stage_plain`` /
  ``hybrid_final_plain`` and the attention between launches) against
  ``stacked_denoiser_pallas_apply(interpret=True)`` at L = 16, for an
  unconditioned and a class-conditioned pack, in float32 and in bf16;
* each hybrid plain version against one ``_run_stage`` launch of
  ``_hybrid_stage_kernel`` / ``_hybrid_final_kernel`` in interpret mode;
* ``attention_stacked`` against ``_attention_stacked``, float32 and bf16;
* ``decoder_fast_apply`` against JAX's in interpret mode;
* the refusals: ``fuse_stages=True`` and every sampler at L = 16, an
  unguided ppc ``ldm_generate``; L = 4 unchanged;
* a region-conditioned ppc ``ldm_generate`` with CFG (DPM++) against JAX's
  ``ldm_generate(denoiser_impl="stacked", decoder_impl="flax")``, whose
  stacked denoiser computes the same attention in XLA, with the hybrid
  launches counted.

Sizes: L = 16 (the ppc latent and the decoder), ``block_channels`` (32, 64),
BG = 8 rows, clouds of 64 points with PVCNN cut as in
``tests/test_torch_port_pipeline.py``, 4 sampler steps. Weights are
initialised by JAX and carried across by ``graspldm_tpu_torch.utils.convert``;
inputs come from ``np.random.default_rng``.

Tolerances. float32: atol 2e-4 / rtol 5e-4 for the networks
(``tests/test_torch_port_denoiser.py``), 5e-4 for generation. bf16, the
whole chain: 2^-5 of the output's largest magnitude (4 bf16 ulps there);
the port's ResnetBlocks round where its kernels do, which is not exactly
where the Pallas kernels do, so a rounding may land an ulp apart and carry
(read: 1.1e-2 relative; JAX's hybrid route is itself 0.9e-2 from its flax
module). bf16, the attention alone: it follows XLA's roundings, so at most
one bf16 ulp of the output's largest magnitude apart (2^-7 relative) in
at most 1 % of the entries (read: 4 of 2048).
"""

import contextlib
import inspect
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graspldm_tpu.diffusion import ElucidatedDiffusion as JED
from graspldm_tpu.diffusion.schedules import DiffusionSchedule as JSchedule
from graspldm_tpu.inference.pipeline import ldm_generate as j_ldm_generate
from graspldm_tpu.models import GraspCVAE as JCVAE
from graspldm_tpu.models import GraspLatentDDM as JDDM
from graspldm_tpu.models import fast_decoder as jfd
from graspldm_tpu.models import pallas_sampler as jps
from graspldm_tpu.models import stacked_pallas as jsp
from graspldm_tpu.models.conditioning import ClassConditionedGraspLatentDDM as JClassDDM
from graspldm_tpu.models.conditioning import RegionConditionedGraspLatentDDM as JRegionDDM
from graspldm_tpu.models.fused_denoiser import DenoiserDims as JDims
from graspldm_tpu.models.stacked_denoiser import _attention_stacked
from graspldm_tpu.models.stacked_denoiser import compute_extra_emb as j_extra_emb
from graspldm_tpu.models.stacked_denoiser import compute_input_emb as j_input_emb
from graspldm_tpu.utils.normalization import normalize_pc_and_grasps as j_normalize

from graspldm_tpu_torch.diffusion import DiffusionSchedule, ElucidatedDiffusion
from graspldm_tpu_torch.inference import ldm_generate
from graspldm_tpu_torch.models import (
    ClassConditionedGraspLatentDDM,
    GraspCVAE,
    GraspLatentDDM,
    RegionConditionedGraspLatentDDM,
)
from graspldm_tpu_torch.models import cuda_sampler as cs
from graspldm_tpu_torch.models import fast_decoder as tfd
from graspldm_tpu_torch.models import stacked_cuda as sc
from graspldm_tpu_torch.models.stacked_denoiser import (
    FLAGSHIP_DIMS,
    DenoiserDims,
    attention_stacked,
    compute_extra_emb,
    compute_input_emb,
    pack_math_weights,
)
from graspldm_tpu_torch.utils import convert
from graspldm_tpu_torch.utils.normalization import normalize_pc_and_grasps

KERNEL_TOL = dict(atol=2e-4, rtol=5e-4)
GEN_TOL = dict(atol=5e-4, rtol=5e-4)
BF16_CHAIN_REL = 2.0 ** -5
BF16_ATTN_REL, BF16_ATTN_FRACTION = 2.0 ** -7, 0.01
L, BC, BG, PTS, STEPS = 16, (32, 64), 8, 64, 4
B, G, P = 2, 4, 32
PC_LATENT = 256
DIMS = dict(seq_len=L, block_channels=BC, groups=4, emb_dim=4 * L, cond_channels=3,
            cond_dim=PC_LATENT, fourier_dim=16)
JD, TD = JDims(**DIMS), DenoiserDims(**DIMS)
VAE = dict(grasp_latent_size=L, pc_latent_size=PC_LATENT, pc_latent_channels=3,
           block_channels=BC, dropout=None, pc_num_points=PTS, pc_scale_channels=0.125,
           pc_scale_voxel_resolution=0.25)
DDM = dict(latent_in_features=L, pc_latent_size=PC_LATENT, block_channels=BC, dropout=None)
KINDS = {None: (JDDM, GraspLatentDDM, convert.grasp_ldm_state_dict, "cls_cond"),
         "class": (JClassDDM, ClassConditionedGraspLatentDDM,
                   convert.class_conditioned_ldm_state_dict, "cls_cond"),
         "region": (JRegionDDM, RegionConditionedGraspLatentDDM,
                    convert.region_conditioned_ldm_state_dict, "region_points")}
DT = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@contextlib.contextmanager
def _flags():
    """Both packages' attention-placement flags on, patched."""
    with mock.patch.object(jsp, "XLA_ATTENTION", True), \
            mock.patch.object(sc, "XLA_ATTENTION", True):
        yield


@pytest.fixture(scope="module")
def m():
    rng = np.random.default_rng(0)
    pc = (rng.normal(0.0, 0.04, size=(B, PTS, 3))
          + rng.uniform(-0.5, 0.5, size=(B, 1, 3))).astype(np.float32)
    x = rng.normal(size=(BG, 1, L)).astype(np.float32)
    t = (np.arange(BG) * 127 % 1000).astype(np.int32)
    zc = rng.normal(size=(BG, 3, PC_LATENT)).astype(np.float32)
    cond = {"cls_cond": rng.uniform(0.0, 3.0, size=BG).astype(np.float32),
            "region_points": rng.normal(0.0, 0.05, size=(BG, P, 3)).astype(np.float32)}
    out = dict(pc=pc, x=x, t=t, zc=zc, cond=cond)
    for kind, (jcls, tcls, to_sd, ckey) in KINDS.items():
        jddm = jcls(**DDM)
        kw = {} if kind is None else {ckey: cond[ckey]}
        dv = jax.tree.map(np.asarray, jax.jit(jddm.init)(jax.random.PRNGKey(1), x, t, zc, **kw))
        ddm = tcls(**DDM).eval()
        ddm.load_state_dict(to_sd(dv), strict=True)
        out[kind] = dict(jddm=jddm, dv=dv, ddm=ddm, math=pack_math_weights(ddm, TD))
        if kind != "region":
            with _flags():  # JAX reads its flag while packing, too
                out[kind]["jw"] = {k: jsp.pack_pallas_weights(dv, JD, dtype=jdt)
                                   for k, (_, jdt) in DT.items()
                                   if kind is None or k == "fp32"}
    jvae = JCVAE(**VAE)
    out["vv"] = jax.tree.map(np.asarray, jax.jit(jvae.init)(
        jax.random.PRNGKey(0), pc, rng.normal(size=(4, 7)).astype(np.float32)))
    vae = GraspCVAE(**VAE).eval()
    vae.load_state_dict(convert.grasp_cvae_state_dict(out["vv"]), strict=True)
    out["jvae"], out["vae"] = jvae, vae
    out["jpc_n"], _, out["jmeta"] = j_normalize(pc, np.zeros((B, 1, 6), np.float32))
    out["pc_n"], _, out["meta"] = normalize_pc_and_grasps(_t(pc), torch.zeros(B, 1, 6))
    return out


def _spy(monkeypatch):
    """Calls of the stacked_cuda wrappers made by ``stacked_denoiser_apply``
    (on CPU tensors they run their plain versions and count nothing)."""
    calls = []
    for name in ("stage_apply", "final_apply", "full_apply", "hybrid_stage_apply",
                 "hybrid_final_apply"):
        real = getattr(sc, name)
        monkeypatch.setattr(sc, name, lambda *a, _r=real, _n=name, **k: (calls.append(_n),
                                                                          _r(*a, **k))[1])
    return calls


@pytest.mark.parametrize("kind,dt", [(None, "fp32"), ("class", "fp32"), (None, "bf16")])
def test_hybrid_chain_matches_jax_interpret(m, kind, dt, monkeypatch):
    net = m[kind]
    tdt, jdt = DT[dt]
    extra = {} if kind is None else {"cls_cond": m["cond"]["cls_cond"]}
    jw = net["jw"][dt]
    je = j_extra_emb(jw, **extra)
    w = sc.PackedNet(net["math"], TD, tdt)
    ie = compute_input_emb(w.aux, _t(m["zc"]))
    if extra:
        ie = ie + compute_extra_emb(w.aux, cls_cond=_t(extra["cls_cond"]))[:, None, :]
    calls = _spy(monkeypatch)
    with _flags():
        want = jsp.stacked_denoiser_pallas_apply(jw, m["x"], m["t"], m["zc"], JD, block_rows=BG,
                                                 interpret=True, extra_emb=je)
        got = sc.stacked_denoiser_apply(w, _t(m["x"]), _t(m["t"]), None, ie)
    assert calls == ["hybrid_stage_apply"] * len(BC) + ["hybrid_final_apply"]
    assert got.dtype == tdt and got.shape == (BG, 1, L)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dt == "fp32":
        np.testing.assert_allclose(_np(got), want, **KERNEL_TOL)
    else:
        err = np.abs(_np(got) - want).max() / np.abs(want).max()
        assert err <= BF16_CHAIN_REL, err


@pytest.mark.parametrize("stage", [0, 1, "final"])
def test_hybrid_plain_versions_match_one_pallas_launch(m, stage):
    """``hybrid_stage_plain`` / ``hybrid_final_plain`` against one
    ``_run_stage`` launch (``_hybrid_stage_kernel`` / ``_hybrid_final_kernel``
    in interpret mode) on the same operands; the input width is the
    previous stage's (stage 0: the init conv's)."""
    net = m[None]
    final = stage == "final"
    i = len(BC) if final else stage
    rng = np.random.default_rng(3)
    X = rng.normal(size=(BG, L * TD.cins[max(i - 1, 0)])).astype(np.float32)
    emb = rng.normal(size=(BG, TD.cond_channels * TD.emb_dim)).astype(np.float32)
    w = sc.PackedNet(net["math"], TD)
    with _flags():
        want = jsp._run_stage(net["jw"]["fp32"], jnp.asarray(X), jnp.asarray(emb), JD,
                              0 if final else i, final, BG, True)
    got = (sc.hybrid_final_plain(w, _t(X), _t(emb)) if final
           else sc.hybrid_stage_plain(w, i, _t(X), _t(emb)))
    assert got.shape == ((BG, L) if final else (BG, L * TD.cins[i]))
    np.testing.assert_allclose(_np(got), np.asarray(want), **KERNEL_TOL)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("i", [0, 1])
def test_attention_between_launches_matches_attention_stacked(m, dt, i):
    tdt, jdt = DT[dt]
    rng = np.random.default_rng(4 + i)
    x = jnp.asarray(2.0 * rng.normal(size=(BG, L * TD.cins[i]))).astype(jdt)
    want = np.asarray(jax.jit(lambda a: _attention_stacked(a, m[None]["jw"][dt], i, JD))(x)
                      .astype(jnp.float32))
    w = sc.PackedNet(m[None]["math"], TD, tdt)
    got = attention_stacked(w.w, i, _t(np.asarray(x.astype(jnp.float32))).to(tdt), TD)
    assert got.dtype == tdt
    if dt == "fp32":
        np.testing.assert_allclose(_np(got), want, **KERNEL_TOL)
    else:
        d = np.abs(_np(got) - want)
        assert d.max() <= BF16_ATTN_REL * np.abs(want).max(), d.max()
        assert (d > 0).mean() <= BF16_ATTN_FRACTION, (d > 0).mean()


def test_decoder_fast_apply_under_the_flag_matches_jax(m, monkeypatch):
    """The VAE decoder's core (L = 16) takes the hybrid chain under the
    flag, in both packages (``fast_decoder.py:83``)."""
    rng = np.random.default_rng(6)
    z_h = rng.normal(size=(BG, L)).astype(np.float32)
    dims = tfd.decoder_dims_for(m["vae"])
    calls = _spy(monkeypatch)
    with _flags():
        jw = jfd.pack_decoder_weights(m["vv"], jfd.decoder_dims_for(m["jvae"]), dtype=jnp.float32)
        want = jfd.decoder_fast_apply(jw, z_h, m["zc"], jfd.decoder_dims_for(m["jvae"]),
                                      block_rows=BG, interpret=True)
        got = tfd.decoder_fast_apply(tfd.pack_decoder_weights(m["vae"], dims), _t(z_h),
                                     _t(m["zc"]))
    assert calls == ["hybrid_stage_apply"] * len(BC) + ["hybrid_final_apply"]
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(_np(g_), np.asarray(w_), **KERNEL_TOL)


def test_refusals_under_the_flag_match_jax(m):
    """At L = 16 under the flag both packages refuse ``fuse_stages=True`` and
    every sampler (whole-trajectory and per-step); the port's sampler
    wrappers too."""
    w = sc.PackedNet(m[None]["math"], TD)
    ie = compute_input_emb(w.aux, _t(m["zc"]))
    jw = m[None]["jw"]["fp32"]
    jie = j_input_emb(jw, m["zc"])
    key = jax.random.PRNGKey(0)
    sched, jsched = DiffusionSchedule.create(), JSchedule.create()
    ed, jed = ElucidatedDiffusion(n_dims=L), JED(n_dims=L)
    x_T = torch.zeros(BG, L)
    with _flags():
        with pytest.raises(ValueError, match="fuse_stages"):
            jsp.stacked_denoiser_pallas_apply(jw, m["x"], m["t"], m["zc"], JD, block_rows=BG,
                                              interpret=True, fuse_stages=True)
        with pytest.raises(ValueError, match="fuse_stages"):
            sc.stacked_denoiser_apply(w, _t(m["x"]), _t(m["t"]), None, ie, fuse_stages=True)
        for name, j_call, t_call in (
            ("fused_sample", lambda: jps.fused_sample(jw, JD, jsched, jie, key, BG, 2),
             lambda: cs.fused_sample(w, sched, ie, x_T, 2)),
            ("fused_sample_dpmpp", lambda: jps.fused_sample_dpmpp(jw, JD, jed, jie, key, BG, 2),
             lambda: cs.fused_sample_dpmpp(w, ed, ie, x_T, 2)),
            ("fused_sample_churn", lambda: jps.fused_sample_churn(jw, JD, jed, jie, key, BG, 2),
             lambda: cs.fused_sample_churn(w, ed, ie, x_T, 2)),
        ):
            with pytest.raises(ValueError, match=f"{name} requires in-kernel attention"):
                j_call()
            with pytest.raises(ValueError, match=f"{name} requires in-kernel attention"):
                t_call()
        for name in ("sampler_apply", "ddim_step_apply", "dpmpp_sampler_apply",
                     "dpmpp_step_apply", "churn_sampler_apply", "churn_step_apply"):
            fn = getattr(cs, name)
            n = sum(p.default is p.empty for p in inspect.signature(fn).parameters.values())
            with pytest.raises(ValueError, match=f"{name} requires in-kernel attention"):
                fn(w, *([None] * (n - 1)))


def test_l4_is_unaffected_by_the_flag():
    """The flag acts at L > 4 only: the fpc denoiser's whole-network launch
    and whole-trajectory sampler give what they give without it."""
    torch.manual_seed(0)
    ddm = GraspLatentDDM(dropout=None).eval()
    w = sc.PackedNet(pack_math_weights(ddm, FLAGSHIP_DIMS), FLAGSHIP_DIMS)
    g = torch.Generator().manual_seed(1)
    x, z = torch.randn(5, 1, 4, generator=g), torch.randn(5, 3, 64, generator=g)
    t = torch.arange(5) * 100
    ie = compute_input_emb(w.aux, z)
    sched = DiffusionSchedule.create(beta_start=5e-5, beta_end=1e-3)
    runs = []
    for on in (False, True):
        with mock.patch.object(sc, "XLA_ATTENTION", on):
            runs.append((sc.stacked_denoiser_apply(w, x, t, None, ie, fuse_stages=True),
                         cs.fused_sample(w, sched, ie, x[:, 0], 3)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    with _flags():
        assert not sc._use_xla_attention(FLAGSHIP_DIMS)
        assert not jsp._use_xla_attention(JDims(**dict(DIMS, seq_len=4)))
        assert sc._use_xla_attention(TD) and jsp._use_xla_attention(JD)


def _edm_draws(key, n: int):
    """x_T ``[BG, L]`` at sigma_max as JAX's DPM++ loop draws it."""
    k_init, _ = jax.random.split(key)
    x_T = np.asarray(jax.random.normal(k_init, (B * G, 1, L)))[:, 0]
    return np.asarray(JED(n_dims=L).sample_schedule(n))[0] * x_T


def test_unguided_ppc_ldm_generate_raises_under_the_flag_in_both(m):
    key = jax.random.PRNGKey(2)
    with _flags():
        with pytest.raises(ValueError, match="requires in-kernel attention"):
            j_ldm_generate(m["jvae"], m["vv"], m[None]["jddm"], m[None]["dv"], JED(n_dims=L),
                           m["jpc_n"], G, key, num_inference_steps=2, sampler="dpmpp",
                           denoiser_impl="pallas", decoder_impl="flax")
        with pytest.raises(ValueError, match="requires in-kernel attention"):
            ldm_generate(m["vae"], m[None]["ddm"], ElucidatedDiffusion(n_dims=L), m["pc_n"], G,
                         num_inference_steps=2, sampler="dpmpp")


def test_guided_region_ppc_ldm_generate_under_the_flag_matches_jax(m, monkeypatch):
    """Region-conditioned ppc, DPM++ 4 steps, CFG 1.5: each of the 4
    evaluations is one hybrid chain over the doubled batch (2 hybrid stage
    launches and the final one), and the decode one more chain; no stage,
    final or whole-network launch."""
    net = m["region"]
    region = np.repeat(m["cond"]["region_points"][:B], G, axis=0)
    key = jax.random.PRNGKey(3)
    want = j_ldm_generate(m["jvae"], m["vv"], net["jddm"], net["dv"], JED(n_dims=L), m["jpc_n"],
                          G, key, num_inference_steps=STEPS, sampler="dpmpp", meta=m["jmeta"],
                          region_points=region, cfg_scale=1.5, denoiser_impl="stacked",
                          decoder_impl="flax")
    x_T = _edm_draws(key, STEPS)
    calls = _spy(monkeypatch)
    with _flags():
        got = ldm_generate(m["vae"], net["ddm"], ElucidatedDiffusion(n_dims=L), m["pc_n"], G,
                           num_inference_steps=STEPS, sampler="dpmpp", meta=m["meta"],
                           x_T=_t(x_T), region_points=_t(region), cfg_scale=1.5)
    assert calls.count("hybrid_stage_apply") == len(BC) * (STEPS + 1)
    assert calls.count("hybrid_final_apply") == STEPS + 1
    assert len(calls) == (len(BC) + 1) * (STEPS + 1)
    for k in ("grasps", "grasp_tmrp", "confidence"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), **GEN_TOL, err_msg=k)
