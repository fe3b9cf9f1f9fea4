"""Port parity, guidance: success guidance's gradient, the guided samplers,
the refusals and the class-conditioned server of ``graspldm_tpu_torch``
against the JAX package on the CPU. ``ldm_generate`` as a whole is held in
``tests/test_torch_port_guided_generate.py``.

* ``make_success_guidance``: the gradient of ``sum log sigmoid(cls_logit)``
  through the port's ``GraspCVAE.decode`` against JAX's through the flax
  decoder, in float32 and with the decoder computing in bf16 (against
  JAX's bf16 gradient, which lies about a fifth of its largest entry away
  from its float32 one);
* ``GraspCVAE.decode`` in float32 (``decoder_dtype=None``), bitwise
  against the same decode written with the stock torch modules;
* ``GaussianDiffusion1D.sample`` (DDIM, DDPM), ``sample_dpmpp`` and
  ``sample_churn`` with a ``guidance_fn`` over the flagship denoiser (flax
  in JAX, the converted ``nn.Module`` here), with trajectories, fed JAX's
  own draws; the guidance is one closed form in both frameworks, so the
  samplers' score shifts are what is compared;
* ``ldm_generate``'s refusals (``cfg_scale`` without a conditioned
  denoiser, a condition the denoiser does not take);
* ``make_batch_generate_from_parts`` of a class-conditioned model behind
  ``GraspServer``.

Sizes as ``tests/test_torch_port_pipeline.py``: 64-point clouds,
``block_channels`` (16, 32), B = 2 clouds x G = 4 grasps, 4 sampler steps;
the sampler tests run the flagship denoiser's widths at BG = 8.

Tolerances (float32): the gradient 1e-4 relative, 1e-6 absolute (one
decoder forward and backward, reordered sums); bf16: 4e-2 of the
gradient's largest entry, a fifth of bf16's own move of it; the samplers 5e-4 absolute
and relative, the JAX package's sampler precedent
(``tests/test_fused_denoiser.py:322``).
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graspldm_tpu.diffusion import ElucidatedDiffusion as JED
from graspldm_tpu.diffusion import GaussianDiffusion1D as JGaussian
from graspldm_tpu.diffusion.guidance import make_success_guidance as j_make_success_guidance
from graspldm_tpu.diffusion.schedules import DiffusionSchedule as JSchedule
from graspldm_tpu.flagship import FlagshipConfig as JConfig
from graspldm_tpu.flagship import build_flagship as j_build
from graspldm_tpu.models import GraspLatentDDM as JDDM

from graspldm_tpu_torch.diffusion import (
    DiffusionSchedule,
    ElucidatedDiffusion,
    GaussianDiffusion1D,
    make_success_guidance,
)
from graspldm_tpu_torch.flagship import FlagshipConfig, build_flagship
from graspldm_tpu_torch.inference import ldm_generate
from graspldm_tpu_torch.models import GraspLatentDDM
from graspldm_tpu_torch.serving import DynamicBatcher, GraspServer, make_batch_generate_from_parts
from graspldm_tpu_torch.utils.convert import grasp_cvae_state_dict, grasp_ldm_state_dict

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
BF16_GRAD_TOL = 4e-2
TOL = dict(atol=5e-4, rtol=5e-4)
CFG = dict(pc_num_points=64, pc_scale_channels=0.125, pc_scale_voxel_resolution=0.25,
           block_channels=(16, 32), dropout=None)
B, G, BG = 2, 4, 8
SCHEDULE = dict(num_steps=1000, beta_start=5e-5, beta_end=1e-3)  # the flagship's


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _clouds(rng):
    return (rng.normal(0.0, 0.04, size=(B, CFG["pc_num_points"], 3))
            + rng.uniform(-0.5, 0.5, size=(B, 1, 3))).astype(np.float32)


@pytest.fixture(scope="module")
def vaes():
    """The reduced flagship's VAE in JAX (float32 and bf16 decoder, same
    variables) and in the port, and z_pc for B clouds repeated G times."""
    rng = np.random.default_rng(0)
    jvae = j_build(JConfig(**CFG))[0]
    jvae16 = j_build(JConfig(**CFG, denoiser_dtype="bfloat16"))[0]
    pc = _clouds(rng)
    vv = jax.tree.map(np.asarray, jax.jit(jvae.init)(
        jax.random.PRNGKey(0), pc, rng.normal(size=(4, 7)).astype(np.float32)))
    vae = build_flagship(FlagshipConfig(**CFG), device="cpu")[0]
    vae.load_state_dict(grasp_cvae_state_dict(vv), strict=True)
    vae16 = build_flagship(FlagshipConfig(**CFG, denoiser_dtype="bfloat16"), device="cpu")[0]
    vae16.load_state_dict(grasp_cvae_state_dict(vv), strict=True)
    z_pc = np.asarray(jax.jit(lambda p: jvae.apply(vv, p, method="encode_pc"))(pc))
    return dict(jvae=jvae, jvae16=jvae16, vv=vv, vae=vae, vae16=vae16, pc=pc,
                z_rep=np.repeat(z_pc, G, axis=0))


def test_success_guidance_gradient_matches_jax(vaes):
    """float32: the port's gradient against JAX's, inside ``torch.no_grad``
    as the samplers call it. bf16: JAX's flax decoder computing in bf16
    moves its own gradient by about a fifth of its largest entry here
    (2.1e-1 against its float32 one); the port's decoder with
    ``decoder_dtype=bfloat16`` rounds at the same points, so its gradient
    lies within ``BF16_GRAD_TOL`` of JAX's bf16 gradient (1.7e-2 read on
    the CPU; the two differ only where a sum in another order rounds to
    the other bf16 neighbour, forward or backward)."""
    rng = np.random.default_rng(1)
    x0 = rng.normal(size=(BG, 1, 4)).astype(np.float32)
    want = np.asarray(jax.jit(j_make_success_guidance(vaes["jvae"], vaes["vv"],
                                                      vaes["z_rep"]))(x0))
    fn = make_success_guidance(vaes["vae"], _t(vaes["z_rep"]))
    with torch.no_grad():
        got = fn(_t(x0))
    assert got.shape == (BG, 1, 4) and got.dtype == torch.float32 and not got.requires_grad
    np.testing.assert_allclose(_np(got), want, **GRAD_TOL)
    # rows are independent: one row's gradient alone is its row of the sum's
    with torch.no_grad():
        one = make_success_guidance(vaes["vae"], _t(vaes["z_rep"][:1]))(_t(x0[:1]))
    np.testing.assert_allclose(_np(one), want[:1], **GRAD_TOL)

    bf16 = np.asarray(jax.jit(j_make_success_guidance(vaes["jvae16"], vaes["vv"],
                                                      vaes["z_rep"]))(x0), np.float32)
    gap = np.abs(bf16 - want).max() / np.abs(want).max()
    print(f"bf16 flax decoder vs float32: max |grad diff| / max |grad| = {gap:.3e}")
    assert 1e-2 < gap < 0.5
    # the port's bf16 decoder rounds where flax's does: its gradient is
    # JAX's bf16 one, not the float32 one
    with torch.no_grad():
        got16 = make_success_guidance(vaes["vae16"], _t(vaes["z_rep"]))(_t(x0))
    assert got16.dtype == torch.float32
    gap16 = np.abs(_np(got16) - bf16).max() / np.abs(bf16).max()
    print(f"port bf16 decoder vs flax bf16 decoder: max |grad diff| / max |grad| = {gap16:.3e}")
    assert gap16 <= BF16_GRAD_TOL


def _stock_decode(vae, z_h, z_pc):
    """The float32 decode written with the stock torch modules and ops, as
    the port computed it before the decoder took a compute dtype."""
    import torch.nn.functional as F

    from graspldm_tpu_torch.models.layers import film_scale_shift, standardize_conv_weight

    def block(b, x, scale_shift=None):
        w = standardize_conv_weight(b.proj.weight, 1e-5)
        x = b.norm(F.conv1d(x, w, b.proj.bias, b.proj.stride, b.proj.padding))
        return F.silu(x if scale_shift is None else film_scale_shift(x, *scale_shift))

    def res_block(r, x, emb):
        h = block(r.block2, block(r.block1, x, r.mlp(emb).chunk(2, dim=-1)))
        return h + r.res_conv(x)

    def attention(res, x):  # Residual(PreNorm(LinearAttention1D))
        a, (Bx, _, L) = res.fn.fn, x.shape
        q, k, v = (t.reshape(Bx, a.heads, a.dim_head, L)
                   for t in a.to_qkv(res.fn.norm(x)).chunk(3, dim=1))
        q, k = q.softmax(dim=-2) * (a.dim_head ** -0.5), k.softmax(dim=-1)
        out = torch.einsum("bhde,bhdn->bhen", torch.einsum("bhdn,bhen->bhde", k, v), q)
        return a.to_out(out.reshape(Bx, -1, L)) + x

    d = vae.decoder
    net = d.net
    emb = net.input_emb_layers(z_pc)
    x = net.init_conv(d.in_layer(z_h)[:, None, :])
    for res1, res2, attn, proj in net.blocks:
        x = proj(attention(attn, res_block(res2, res_block(res1, x, emb), emb)))
    h = net.final_conv(res_block(net.final_res_block, x, emb))[:, 0, :]
    return d.tmrp(h), d.class_logits(h)


def test_float32_decode_is_the_stock_modules(vaes):
    """``decoder_dtype=None``: ``GraspCVAE.decode`` is bitwise the stock
    modules' float32 decode (the compute-dtype path leaves it as it was)."""
    rng = np.random.default_rng(2)
    z_h = _t(rng.normal(size=(BG, 4)).astype(np.float32))
    with torch.no_grad():
        got = vaes["vae"].decode(z_h, _t(vaes["z_rep"]))
        want = _stock_decode(vaes["vae"], z_h, _t(vaes["z_rep"]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)


# ---------------------------------------------------------------------------
# the guided Python-loop samplers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def den():
    """The flagship denoiser (L = 4, channels 32/64/128/256, z_pc [3, 64])
    in flax and converted into the port's module."""
    rng = np.random.default_rng(2)
    zc = rng.normal(size=(BG, 3, 64)).astype(np.float32)
    jddm = JDDM(dropout=None)
    dv = jax.tree.map(np.asarray, jax.jit(jddm.init)(
        jax.random.PRNGKey(3), np.zeros((BG, 1, 4), np.float32), np.zeros(BG, np.int32), zc))
    ddm = GraspLatentDDM(dropout=None).eval()
    ddm.load_state_dict(grasp_ldm_state_dict(dv), strict=True)
    return dict(apply=jax.jit(jddm.apply), dv=dv, ddm=ddm, zc=zc)


def _loop_draws(key, sampler: str, n: int):
    """x_T and the per-step noise as the JAX package's Python-loop samplers
    draw them, ``[BG, 1, 4]`` each (``gaussian.py:120-142``,
    ``elucidated.py:163-172``, ``:224-225``)."""
    k_init, k_loop = jax.random.split(key)
    x_T = np.asarray(jax.random.normal(k_init, (BG, 1, 4)))
    if sampler in ("dpmpp", "churn"):
        x_T = np.asarray(JED(n_dims=4).sample_schedule(n))[0] * x_T
    if sampler in ("ddim", "dpmpp"):
        return x_T, None
    noise = []
    for _ in range(n):
        k_loop, k_n = jax.random.split(k_loop)
        noise.append(np.asarray(jax.random.normal(k_n, (BG, 1, 4))))
    return x_T, np.stack(noise)


@pytest.mark.parametrize("sampler", ["ddim", "ddpm", "dpmpp", "churn"])
def test_guided_loop_samplers_match_jax(den, sampler):
    """Each sampler's score shift: ``eps -= s sqrt(1-a)/sqrt(a) g(x0_est)``
    (DDIM, DDPM) and ``D += s sigma^2 g(D)`` (DPM++, and both churn
    evaluations of a step), with ``g(x0) = -tanh(x0)`` in both frameworks;
    x_0 and the trajectory against JAX's."""
    key, n, s = jax.random.PRNGKey(11), 4, 0.7
    zc, fn = den["zc"], (lambda x, t, z: den["apply"](den["dv"], x, t, z))
    j_guide = (lambda x0: -jnp.tanh(x0))
    guide = (lambda x0: -torch.tanh(x0))
    kw = dict(return_trajectory=True, guidance_fn=j_guide, guidance_scale=s)
    if sampler in ("ddim", "ddpm"):
        want = JGaussian(schedule=JSchedule.create(**SCHEDULE), n_dims=4).sample(
            fn, key, batch_size=BG, z_cond=zc, num_inference_steps=n, sampler=sampler, **kw)
    else:
        jed = JED(n_dims=4)
        jfn = jed.sample_dpmpp if sampler == "dpmpp" else jed.sample_churn
        want = jfn(fn, key, batch_size=BG, z_cond=zc, num_sample_steps=n, **kw)
    x_T, noise = _loop_draws(key, sampler, n)
    nz = None if noise is None else _t(noise)

    @torch.no_grad()
    def run(guidance_fn):
        kw = dict(z_cond=_t(zc), x_T=_t(x_T), return_trajectory=True,
                  guidance_fn=guidance_fn, guidance_scale=s)
        if sampler in ("ddim", "ddpm"):
            diff = GaussianDiffusion1D(schedule=DiffusionSchedule.create(**SCHEDULE), n_dims=4)
            return diff.sample(den["ddm"], BG, num_inference_steps=n, sampler=sampler,
                               noise=nz, **kw)
        ed = ElucidatedDiffusion(n_dims=4)
        if sampler == "dpmpp":
            return ed.sample_dpmpp(den["ddm"], BG, num_sample_steps=n, **kw)
        return ed.sample_churn(den["ddm"], BG, num_sample_steps=n, noise=nz, **kw)

    got = run(guide)
    assert got[1].shape == want[1].shape
    for g, w, what in zip(got, want, ("x_0", "trajectory")):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL, err_msg=what)
    # the guidance moved the result: without it x_0 differs
    assert (run(None)[0] - got[0]).abs().max() > 1e-3


# ---------------------------------------------------------------------------
# refusals and the class-conditioned server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models(vaes):
    """The reduced flagship's port models, unconditioned and class- /
    region-conditioned (random weights; the VAE's are JAX's)."""
    out = {}
    for kind in (None, "class", "region"):
        _, ddm, diff = build_flagship(FlagshipConfig(**CFG, conditioning=kind),
                                      generator=torch.Generator().manual_seed(4), device="cpu")
        out[kind] = (vaes["vae"], ddm, diff)
    pc = _t(vaes["pc"])
    return dict(out, pc=pc - pc.mean(dim=1, keepdim=True))


@pytest.mark.parametrize("kind,option,match", [
    (None, dict(cfg_scale=2.0), "conditioned denoiser"),
    (None, dict(cfg_scale=2.0, guidance_scale=1.0), "conditioned denoiser"),
    (None, dict(cls_cond=torch.zeros(BG)), "kernel path supports"),
    ("class", {}, "kernel path supports"),
    ("class", dict(cfg_scale=2.0), "kernel path supports"),
    ("class", dict(region_points=torch.zeros(BG, 8, 3)), "kernel path supports"),
    ("region", dict(cls_cond=torch.zeros(BG)), "kernel path supports"),
])
def test_ldm_generate_refuses_what_the_denoiser_does_not_take(models, kind, option, match):
    """The JAX package's rules (``pipeline.py:_resolve_denoiser_impl``,
    ``_make_cfg_denoise_fn``): CFG needs a conditioned denoiser, and a
    denoiser takes exactly its own condition."""
    with pytest.raises(ValueError, match=match):
        ldm_generate(*models[kind], models["pc"], G, num_inference_steps=2, **option)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_class_conditioned_server(models):
    """A class-conditioned denoiser: each request's ``cls`` is repeated over its
    grasps, so a batch's result is ``ldm_generate`` with ``cls_cond``
    repeated G times; a request without ``cls`` is refused, and so is a
    ``cls`` sent to an unconditioned model."""
    vae, ddm, diff = models["class"]
    kw = dict(device="cpu", num_grasps=G, num_inference_steps=3, seed=5)
    fn = make_batch_generate_from_parts(vae, ddm, diff, **kw)
    pcs = _np(models["pc"]) + np.float32(2.0)
    cls = np.array([0.0, 2.0], np.float32)
    got = fn(pcs, cls)
    from graspldm_tpu_torch.utils.normalization import normalize_pc_and_grasps

    pc_n, _, meta = normalize_pc_and_grasps(_t(pcs), torch.zeros(B, 1, 6))
    want = ldm_generate(vae, ddm, diff, pc_n, G, torch.Generator().manual_seed(5),
                        num_inference_steps=3, meta=meta,
                        cls_cond=_t(cls).repeat_interleave(G))
    for k in ("grasps", "grasp_tmrp", "confidence"):
        np.testing.assert_array_equal(got[k], _np(want[k]), err_msg=k)
    with pytest.raises(ValueError, match="needs 'cls'"):
        fn(pcs, None)
    plain_fn = make_batch_generate_from_parts(*models[None], **kw)
    with pytest.raises(ValueError, match="not class-conditioned"):
        plain_fn(pcs, cls)
    with pytest.raises(ValueError, match="class-conditioned"):
        make_batch_generate_from_parts(*models["region"], **kw)

    batcher = DynamicBatcher(fn, num_points=CFG["pc_num_points"], max_batch=2,
                             max_wait_ms=200.0, requires_cls=ddm.conditioning == "class")
    server = GraspServer(batcher, host="127.0.0.1", port=0, info={"num_grasps": G})
    server.start_background()
    try:
        host, port = server.address[:2]
        url = f"http://{host}:{port}/v1/generate"
        rng = np.random.default_rng(6)
        status, body = _post(url, {"points": (rng.normal(0.0, 0.03, size=(50, 3)) + 1.0).tolist(),
                                   "num_grasps": 2, "cls": 1.0})
        assert status == 200, body
        H = np.asarray(body["grasps"])
        assert H.shape == (2, 4, 4) and np.isfinite(H).all() and body["num_grasps"] == 2
        R = H[:, :3, :3]
        np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape),
                                   atol=1e-5)
        assert _post(url, {"points": [[0.0, 0.0, 0.0]], "num_grasps": 1})[0] == 400
        assert batcher.stats()["errors"] == 0
    finally:
        server.shutdown()
