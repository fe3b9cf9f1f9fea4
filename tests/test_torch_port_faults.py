"""Port parity for three capabilities the JAX package has and the port
once refused: the plain-module generation route (``denoiser_impl`` /
``decoder_impl``), the non-linear beta schedules, and PVCNN attention.

* The plain-module route: ``ldm_generate`` of a denoiser with learned
  sinusoidal time features and of a latent-8 model with a resolution-8
  decoder (both outside the kernels' rules, so ``"auto"`` takes the
  modules), and classifier-free guidance on that route, against the JAX
  package's ``denoiser_impl="flax"``; ``vae_generate`` with every
  ``decoder_impl``; which route ``"auto"`` picks; the refusals of the
  kernel route.
* The schedules: the betas of ``linear``, ``scaled_linear``,
  ``squaredcos_cap_v2`` and ``cosine`` against JAX's, and ``ldm_generate``
  on a cosine-schedule flagship.
* PVCNN attention: ``Attention1D`` (float32 and bf16),
  ``PVConv(use_attention=True)``, ``GlobalAttention`` and
  ``PVCNNEncoder(use_global_attention=True)`` through the weight bridge.

Sizes as ``tests/test_torch_port_pipeline.py`` cuts the flagship: 64-point
clouds, ``pc_scale_channels`` 0.125, ``pc_scale_voxel_resolution`` 0.25,
``block_channels`` (16, 32), B = 2 clouds x G = 4 grasps, 4 sampler steps.
Weights are initialised by JAX and carried across by
``graspldm_tpu_torch.utils.convert``; clouds come from
``np.random.default_rng``; x_T, z_h and the DDPM noise are JAX's draws.

Tolerances: generation 5e-4 absolute and relative (float32; the JAX
package's sampler precedent, ``tests/test_fused_denoiser.py:322``); the
modules 1e-4 of the output's largest magnitude (float32, as
``tests/test_torch_port_pvcnn2.py``), bf16 ``Attention1D`` 2^-6 of it (a
bf16 ulp at the output's scale: the two frameworks sum the products in
float32 in another order, so a rounding may land one ulp apart). Betas:
``cosine`` bitwise; ``linear`` within 1 ulp and ``scaled_linear`` within 4
(XLA folds ``jnp.linspace`` into other float32 arithmetic than
``torch.linspace``, 1 ulp, which the square doubles).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graspldm_tpu.diffusion import GaussianDiffusion1D as JGaussian
from graspldm_tpu.diffusion.schedules import DiffusionSchedule as JSchedule
from graspldm_tpu.diffusion.schedules import make_beta_schedule as j_betas
from graspldm_tpu.flagship import FlagshipConfig as JConfig
from graspldm_tpu.flagship import build_flagship as j_build
from graspldm_tpu.inference.pipeline import ldm_generate as j_ldm_generate
from graspldm_tpu.inference.pipeline import vae_generate as j_vae_generate
from graspldm_tpu.models import GraspCVAE as JCVAE
from graspldm_tpu.models import GraspLatentDDM as JDDM
from graspldm_tpu.models import layers as jlayers
from graspldm_tpu.models import pvcnn as jpv
from graspldm_tpu.utils.normalization import normalize_pc_and_grasps as j_normalize

from graspldm_tpu_torch.diffusion import DiffusionSchedule, GaussianDiffusion1D
from graspldm_tpu_torch.diffusion.schedules import make_beta_schedule
from graspldm_tpu_torch.flagship import FlagshipConfig, build_flagship
from graspldm_tpu_torch.inference import ldm_generate, pipeline as pl, vae_generate
from graspldm_tpu_torch.models import GraspCVAE, GraspLatentDDM
from graspldm_tpu_torch.models import layers as tlayers
from graspldm_tpu_torch.models import pvcnn as tpv
from graspldm_tpu_torch.utils import convert
from graspldm_tpu_torch.utils.normalization import normalize_pc_and_grasps

TOL = dict(atol=5e-4, rtol=5e-4)
MODULE_REL = 1e-4
BF16_REL = 2.0 ** -6
PC = dict(pc_num_points=64, pc_scale_channels=0.125, pc_scale_voxel_resolution=0.25)
CFG = dict(PC, block_channels=(16, 32), dropout=None)
VAE = dict(PC, block_channels=(16, 32), dropout=None, pc_latent_size=64, pc_latent_channels=3)
B, G, STEPS = 2, 4, 4
BG = B * G
KEYS = ("grasps", "grasp_tmrp", "confidence")
SCHEDULE = dict(num_steps=1000, beta_start=5e-5, beta_end=1e-3)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _draws(key, n: int, d: int, ddpm: bool = False):
    """x_T ``[BG, d]`` (and the DDPM noise ``[n, BG, d]``) as the JAX
    package's ``GaussianDiffusion1D.sample`` draws them."""
    k_init, k_loop = jax.random.split(key)
    x_T = np.asarray(jax.random.normal(k_init, (BG, 1, d)))[:, 0]
    if not ddpm:
        return x_T, None
    noise = []
    for _ in range(n):
        k_loop, k_n = jax.random.split(k_loop)
        noise.append(np.asarray(jax.random.normal(k_n, (BG, 1, d)))[:, 0])
    return x_T, np.stack(noise)


def _vae_pair(rng, pc, **kw):
    jvae = JCVAE(**VAE, **kw)
    vv = jax.tree.map(np.asarray, jax.jit(jvae.init)(
        jax.random.PRNGKey(0), pc, rng.normal(size=(4, 7)).astype(np.float32)))
    vae = GraspCVAE(**VAE, **kw).eval()
    vae.load_state_dict(convert.grasp_cvae_state_dict(vv), strict=True)
    return jvae, vv, vae


def _ddm_pair(rng, L: int, **kw):
    jddm = JDDM(latent_in_features=L, block_channels=(16, 32), dropout=None, **kw)
    x = rng.normal(size=(4, 1, L)).astype(np.float32)
    zc = rng.normal(size=(4, 3, 64)).astype(np.float32)
    dv = jax.tree.map(np.asarray, jax.jit(jddm.init)(
        jax.random.PRNGKey(1), x, np.zeros(4, np.int32), zc))
    ddm = GraspLatentDDM(latent_in_features=L, block_channels=(16, 32), dropout=None, **kw)
    ddm.load_state_dict(convert.grasp_ldm_state_dict(dv), strict=True)
    return jddm, dv, ddm.eval()


@pytest.fixture(scope="module")
def m():
    """The reduced flagship (z4, decoder resolution 16), a learned-sinusoidal
    z4 denoiser, a z8 denoiser with a resolution-8 z8 VAE, and a
    class-conditioned denoiser, in both packages."""
    rng = np.random.default_rng(0)
    pc = (rng.normal(0.0, 0.04, size=(B, PC["pc_num_points"], 3))
          + rng.uniform(-0.5, 0.5, size=(B, 1, 3))).astype(np.float32)
    out = dict(pc=pc, cls=np.repeat(rng.uniform(0.0, 3.0, size=B).astype(np.float32), G))
    out["vae"] = _vae_pair(rng, pc)
    out["vae8"] = _vae_pair(rng, pc, grasp_latent_size=8, intermediate_feature_resolution=8)
    out["flagship"] = _ddm_pair(rng, 4)
    out["learned"] = _ddm_pair(rng, 4, learned_sinusoidal_cond=True,
                               random_fourier_features=False)
    out["z8"] = _ddm_pair(rng, 8)
    _, jddm, jdiff = j_build(JConfig(**CFG, conditioning="class"))
    x = rng.normal(size=(4, 1, 4)).astype(np.float32)
    zc = rng.normal(size=(4, 3, 64)).astype(np.float32)
    dv = jax.tree.map(np.asarray, jax.jit(jddm.init)(
        jax.random.PRNGKey(2), x, np.zeros(4, np.int32), zc, cls_cond=out["cls"][:4]))
    _, ddm, diff = build_flagship(FlagshipConfig(**CFG, conditioning="class"), device="cpu")
    ddm.load_state_dict(convert.class_conditioned_ldm_state_dict(dv), strict=True)
    out["class"] = (jddm, dv, ddm)
    out["jdiff"], out["diff"] = jdiff, diff
    out["jdiff8"] = JGaussian(schedule=JSchedule.create(**SCHEDULE), n_dims=8)
    out["diff8"] = GaussianDiffusion1D(schedule=DiffusionSchedule.create(**SCHEDULE), n_dims=8)
    out["jpc_n"], _, out["jmeta"] = j_normalize(pc, np.zeros((B, 1, 6), np.float32))
    out["pc_n"], _, out["meta"] = normalize_pc_and_grasps(_t(pc), torch.zeros(B, 1, 6))
    return out


def _check(got, want):
    assert got["grasps"].shape == (B, G, 4, 4)
    for k in KEYS:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), **TOL, err_msg=k)


# ---------------------------------------------------------------------------
# fault 1: the plain-module route
# ---------------------------------------------------------------------------

MODULE_CASES = {
    # (vae, denoiser, diffusion, latent, sampler, port options)
    "learned-sinusoidal-ddim": ("vae", "learned", "", 4, "ddim", {}),
    "learned-sinusoidal-ddpm-module-decoder": ("vae", "learned", "", 4, "ddpm",
                                               dict(decoder_impl="module")),
    "z8-res8-ddim": ("vae8", "z8", "8", 8, "ddim", {}),
    "flagship-module-route": ("vae", "flagship", "", 4, "ddpm",
                              dict(denoiser_impl="module", decoder_impl="module")),
}


@pytest.mark.parametrize("case", list(MODULE_CASES))
def test_module_route_ldm_generate_matches_jax_flax(m, case):
    vae_key, ddm_key, diff8, L, sampler, opts = MODULE_CASES[case]
    jvae, vv, vae = m[vae_key]
    jddm, dv, ddm = m[ddm_key]
    key = jax.random.PRNGKey(7)
    want = j_ldm_generate(jvae, vv, jddm, dv, m[f"jdiff{diff8}"], m["jpc_n"], G, key,
                          num_inference_steps=STEPS, sampler=sampler, meta=m["jmeta"],
                          denoiser_impl="flax", decoder_impl="flax")
    x_T, noise = _draws(key, STEPS, L, ddpm=sampler == "ddpm")
    got = ldm_generate(vae, ddm, m[f"diff{diff8}"], m["pc_n"], G, num_inference_steps=STEPS,
                       sampler=sampler, meta=m["meta"], x_T=_t(x_T),
                       noise=None if noise is None else _t(noise), **opts)
    _check(got, want)


def test_module_route_cfg_matches_jax_flax(m):
    """Classifier-free guidance on the module route: one doubled-batch call
    with ``cond_mask`` 1 then 0 per evaluation, as JAX's flax route."""
    jvae, vv, vae = m["vae"]
    jddm, dv, ddm = m["class"]
    key = jax.random.PRNGKey(8)
    want = j_ldm_generate(jvae, vv, jddm, dv, m["jdiff"], m["jpc_n"], G, key,
                          num_inference_steps=STEPS, meta=m["jmeta"], cls_cond=m["cls"],
                          cfg_scale=2.0, denoiser_impl="flax", decoder_impl="flax")
    x_T, _ = _draws(key, STEPS, 4)
    got = ldm_generate(vae, ddm, m["diff"], m["pc_n"], G, num_inference_steps=STEPS,
                       meta=m["meta"], x_T=_t(x_T), cls_cond=_t(m["cls"]), cfg_scale=2.0,
                       denoiser_impl="module", decoder_impl="module")
    _check(got, want)


@pytest.mark.parametrize("vae_key,impl", [("vae", "kernels"), ("vae", "module"),
                                          ("vae", "auto"), ("vae8", "auto"),
                                          ("vae8", "module")])
def test_vae_generate_decoder_impls_match_jax_flax(m, vae_key, impl):
    jvae, vv, vae = m[vae_key]
    key = jax.random.PRNGKey(9)
    want = j_vae_generate(jvae, vv, m["jpc_n"], G, key, meta=m["jmeta"], decoder_impl="flax")
    z_h = np.asarray(jax.random.normal(key, (BG, vae.grasp_latent_size)))
    got = vae_generate(vae, m["pc_n"], G, meta=m["meta"], z_h=_t(z_h), decoder_impl=impl)
    _check(got, want)


def test_auto_takes_the_kernels_for_the_flagship_and_the_modules_otherwise(m, monkeypatch):
    """``"auto"`` by model: the flagship's denoiser and decoder take the
    kernel route (one whole-trajectory sampler call, one kernel decode),
    the learned-sinusoidal denoiser and the resolution-8 decoder the
    modules (their forwards run; no kernel wrapper is called)."""
    calls = []
    for name in ("fused_sample", "decoder_fast_apply", "stacked_denoiser_apply"):
        real = getattr(pl, name)
        monkeypatch.setattr(pl, name, lambda *a, _r=real, _n=name, **k: (calls.append(_n),
                                                                          _r(*a, **k))[1])
    assert pl.resolve_denoiser_impl(m["flagship"][2]) == "kernels"
    assert pl.resolve_decoder_impl(m["vae"][2]) == "kernels"
    assert pl.resolve_denoiser_impl(m["learned"][2]) == "module"
    assert pl.resolve_denoiser_impl(m["z8"][2]) == "module"
    assert pl.resolve_decoder_impl(m["vae8"][2]) == "module"
    ldm_generate(m["vae"][2], m["flagship"][2], m["diff"], m["pc_n"], G,
                 num_inference_steps=STEPS)
    assert calls == ["fused_sample", "decoder_fast_apply"]
    calls.clear()
    seen = []
    hooks = [mod.register_forward_hook(lambda *a, _n=n: seen.append(_n))
             for n, mod in (("denoiser", m["z8"][2]), ("decoder", m["vae8"][2].decoder.net))]
    try:
        ldm_generate(m["vae8"][2], m["z8"][2], m["diff8"], m["pc_n"], G,
                     num_inference_steps=STEPS)
    finally:
        for h in hooks:
            h.remove()
    assert calls == []
    assert seen == ["denoiser"] * STEPS + ["decoder"]
    weights = pl.pack_generation_weights(m["vae8"][2], m["z8"][2], device="cpu")
    assert weights.decoder is None and weights.denoiser is None


def test_kernel_route_refuses_what_the_kernels_do_not_take(m):
    """``"kernels"`` on a model outside the rules raises ``ValueError``, as
    JAX's ``"pallas"`` does (``pipeline.py:163``, ``_make_decode_fn``); so
    does an unknown route."""
    jvae, vv, vae = m["vae"]
    jddm, dv, ddm = m["learned"]
    key = jax.random.PRNGKey(10)
    with pytest.raises(ValueError, match="random Fourier"):
        j_ldm_generate(jvae, vv, jddm, dv, m["jdiff"], m["jpc_n"], G, key,
                       num_inference_steps=STEPS, denoiser_impl="pallas")
    with pytest.raises(ValueError, match="random Fourier"):
        ldm_generate(vae, ddm, m["diff"], m["pc_n"], G, num_inference_steps=STEPS,
                     denoiser_impl="kernels")
    jvae8, vv8, vae8 = m["vae8"]
    with pytest.raises(ValueError, match="resolution"):
        j_vae_generate(jvae8, vv8, m["jpc_n"], G, key, decoder_impl="pallas")
    with pytest.raises(ValueError, match="resolution"):
        vae_generate(vae8, m["pc_n"], G, decoder_impl="kernels")
    with pytest.raises(ValueError, match="unknown denoiser_impl"):
        ldm_generate(vae, m["flagship"][2], m["diff"], m["pc_n"], G, denoiser_impl="pallas")
    with pytest.raises(ValueError, match="weights.denoiser is None"):
        ldm_generate(vae, m["flagship"][2], m["diff"], m["pc_n"], G, num_inference_steps=STEPS,
                     weights=pl.pack_generation_weights(vae, ddm, device="cpu"))


# ---------------------------------------------------------------------------
# fault 2: the beta schedules
# ---------------------------------------------------------------------------

ULPS = {"linear": 1, "scaled_linear": 4, "squaredcos_cap_v2": 0, "cosine": 0}


@pytest.mark.parametrize("name", list(ULPS))
@pytest.mark.parametrize("start,end,n", [(5e-5, 1e-3, 1000), (8.5e-4, 1.2e-2, 1000),
                                         (1e-4, 2e-2, 37)])
def test_beta_schedules_match_jax(name, start, end, n):
    want = np.asarray(j_betas(name, n, start, end))
    got = make_beta_schedule(name, n, start, end).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= ULPS[name], ulps.max()
    if name in ("squaredcos_cap_v2", "cosine"):
        assert got.max() <= np.float32(0.999)


def test_unknown_beta_schedule_raises():
    with pytest.raises(ValueError, match="Unknown beta schedule"):
        DiffusionSchedule.create(beta_schedule="sigmoid")


@pytest.mark.parametrize("sampler", ["ddim", "ddpm"])
def test_cosine_schedule_ldm_generate_matches_jax(m, sampler):
    """A cosine-schedule flagship: the kernel route in the port (the
    whole-trajectory sampler's plain version on the CPU) against JAX's."""
    jdiff = j_build(JConfig(**CFG, beta_schedule="squaredcos_cap_v2"))[2]
    diff = build_flagship(FlagshipConfig(**CFG, beta_schedule="squaredcos_cap_v2"),
                          device="cpu")[2]
    jvae, vv, vae = m["vae"]
    jddm, dv, ddm = m["flagship"]
    key = jax.random.PRNGKey(11)
    want = j_ldm_generate(jvae, vv, jddm, dv, jdiff, m["jpc_n"], G, key,
                          num_inference_steps=STEPS + 1, sampler=sampler, meta=m["jmeta"])
    x_T, noise = _draws(key, STEPS + 1, 4, ddpm=sampler == "ddpm")
    got = ldm_generate(vae, ddm, diff, m["pc_n"], G, num_inference_steps=STEPS + 1,
                       sampler=sampler, meta=m["meta"], x_T=_t(x_T),
                       noise=None if noise is None else _t(noise))
    _check(got, want)


# ---------------------------------------------------------------------------
# fault 3: PVCNN attention
# ---------------------------------------------------------------------------


def _close(got: torch.Tensor, want, rel: float = MODULE_REL) -> None:
    want = np.asarray(want, dtype=np.float32)
    got = _np(got.float())
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert np.isfinite(got).all() and err <= rel, err


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_attention1d_matches_jax(dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 24, 16)).astype(np.float32)  # [B, L, C]
    jdt = None if dtype is None else jnp.bfloat16
    jm = jlayers.Attention1D(dtype=jdt)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3), x))
    want = jm.apply(v, x)
    tm = tlayers.Attention1D(16)
    sd = {}
    convert._attention1d(sd, "", v["params"])
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(_t(x).transpose(1, 2), dtype=None if dtype is None else torch.bfloat16)
    assert got.dtype == (torch.float32 if dtype is None else torch.bfloat16)
    _close(got.transpose(1, 2), want.astype(jnp.float32),
           MODULE_REL if dtype is None else BF16_REL)


def _pv_init(module, seed: int, *args):
    key = jax.random.PRNGKey(seed)
    v = jax.tree.map(np.asarray, jax.jit(module.init)({"params": key, "dropout": key}, *args))
    rng = np.random.default_rng(seed)  # BatchNorm statistics off the identity

    def leaf(path, a):
        if path[-1].key == "mean":
            return rng.normal(0.0, 0.1, size=a.shape).astype(np.float32)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, v)


def test_pvconv_voxel_attention_matches_jax():
    rng = np.random.default_rng(4)
    xyz = rng.normal(0.0, 0.3, size=(2, 64, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 64, 5)).astype(np.float32)
    jm = jpv.PVConv(out_channels=8, resolution=4, use_attention=True)
    v = _pv_init(jm, 4, feats, xyz)
    want = jm.apply(v, feats, xyz)
    tm = tpv.PVConv(5, 8, 4, use_attention=True)
    tm.load_state_dict(convert.pvconv_state_dict(v), strict=True)
    assert isinstance(tm.voxel_layers[6], tpv.VoxelAttention)
    with torch.no_grad():
        got = tm.eval()(_t(feats).transpose(1, 2), _t(xyz).transpose(1, 2))
    _close(got.transpose(1, 2), want)


def test_global_attention_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 64, 16)).astype(np.float32)  # [B, N, C]
    jm = jpv._GlobalAttention()
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(5), x))
    want = jm.apply(v, x)
    tm = tpv.GlobalAttention(16)
    sd = {}
    for name in ("q", "k", "v", "out"):
        convert._conv1x1(sd, name, v["params"][name])
    convert._norm(sd, "norm", v["params"]["norm"])
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(_t(x).transpose(1, 2))
    _close(got.transpose(1, 2), want)


def test_pvcnn_encoder_global_attention_matches_jax():
    rng = np.random.default_rng(6)
    xyz = rng.normal(0.0, 0.3, size=(2, 64, 3)).astype(np.float32)
    kw = dict(out_features=12, n_points=64, scale_channels=0.125, scale_voxel_resolution=0.25,
              use_global_attention=True, out_channels=3)
    jm = jpv.PVCNNEncoder(**kw)
    v = _pv_init(jm, 6, xyz)
    want = jm.apply(v, xyz)
    tm = tpv.PVCNNEncoder(**kw)
    tm.load_state_dict(convert.pvcnn_encoder_state_dict(v), strict=True)
    with torch.no_grad():
        got = tm.eval()(_t(xyz))
    assert got.shape == (2, 3, 12)
    _close(got, want)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_packing_follows_the_models_device(device):
    """``pack_generation_weights`` / ``pack_decoder_weights`` / ``PackedNet``
    with no device named pack on the device of the models' parameters
    (the meta device stands in for a card here: packing it onto the CPU
    would raise)."""
    from graspldm_tpu_torch.models.fast_decoder import decoder_dims_for, pack_decoder_weights
    from graspldm_tpu_torch.models.stacked_cuda import PackedNet
    from graspldm_tpu_torch.models.stacked_denoiser import pack_math_weights

    vae, ddm, _ = build_flagship(FlagshipConfig(**CFG), device="cpu")
    vae, ddm = vae.to(device), ddm.to(device)
    w = pl.pack_generation_weights(vae, ddm)
    dims = decoder_dims_for(vae)
    parts = (w.decoder, w.denoiser, pack_decoder_weights(vae, dims),
             PackedNet(pack_math_weights(vae.decoder.net, dims), dims))
    for part in parts:
        assert {t.device.type for t in (part.flat, part.layout, *part.aux.values())} == {device}
