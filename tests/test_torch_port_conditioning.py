"""Port parity, conditioning: the class- and region-conditioned denoisers of
``graspldm_tpu_torch``, their extra embedding, and the whole-network kernel
path (``full_plain``, the plain version of ``full_kernel``) against the JAX
package on the CPU.

* ``ClassConditionedGraspLatentDDM`` / ``RegionConditionedGraspLatentDDM``
  (``cond_mask`` 1 and 0) against the flax modules, after the weights cross
  ``graspldm_tpu_torch.utils.convert``;
* ``compute_extra_emb`` against the JAX package's;
* ``stacked_denoiser_apply(..., fuse_stages=True)`` (``full_plain`` on a CPU
  tensor) against ``stacked_denoiser_pallas_apply(..., interpret=True,
  fuse_stages=True)``, which runs ``stacked_pallas.py:_full_kernel`` in
  interpret mode, unconditioned and class-conditioned, at L = 4 (the fpc
  denoiser, ``z_pc [3, 64]``) and L = 16 (the ppc denoiser, ``z_pc
  [3, 256]``), and against the port's own stage chain.

Flagship widths (channels 32/64/128/256), BG = 8 rows (a multiple of the
Pallas ``block_rows``). Weights are initialised by JAX; inputs come from
``np.random.default_rng``.

Tolerances (float32): the modules and kernels 1e-4 relative, 2e-5
absolute (outputs are O(1); XLA and torch reorder sums, measured ~1e-6);
the extra embedding 1e-6 (one or two small products); the port's chain and
``full_plain`` are the same float32 ops in the same order: bitwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graspldm_tpu.models.conditioning import (
    ClassConditionedGraspLatentDDM as JClassDDM,
    RegionConditionedGraspLatentDDM as JRegionDDM,
)
from graspldm_tpu.models.fused_denoiser import DenoiserDims as JDims
from graspldm_tpu.models import GraspLatentDDM as JDDM
from graspldm_tpu.models.stacked_denoiser import compute_extra_emb as j_extra_emb
from graspldm_tpu.models.stacked_pallas import (
    pack_pallas_weights,
    stacked_denoiser_pallas_apply,
)

from graspldm_tpu_torch.inference.pipeline import _denoiser_dims
from graspldm_tpu_torch.models import (
    ClassConditionedGraspLatentDDM,
    GraspLatentDDM,
    RegionConditionedGraspLatentDDM,
)
from graspldm_tpu_torch.models import stacked_cuda as sc
from graspldm_tpu_torch.models.stacked_denoiser import (
    compute_extra_emb,
    compute_input_emb,
    pack_math_weights,
)
from graspldm_tpu_torch.utils.convert import (
    class_conditioned_ldm_state_dict,
    grasp_ldm_state_dict,
    region_conditioned_ldm_state_dict,
)

TOL = dict(rtol=1e-4, atol=2e-5)
EMB_TOL = dict(rtol=1e-6, atol=1e-6)
BG, P = 8, 32


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _inputs(L: int, cond_dim: int, seed: int):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(BG, 1, L)).astype(np.float32),
        t=((np.arange(BG) * 37 + 5) % 1000).astype(np.int32),
        zc=rng.normal(size=(BG, 3, cond_dim)).astype(np.float32),
        cls=rng.uniform(0.0, 3.0, size=BG).astype(np.float32),
        rp=rng.normal(0.0, 0.05, size=(BG, P, 3)).astype(np.float32),
        mask=np.array([1, 0] * (BG // 2), np.float32),
    )


KINDS = {
    None: (JDDM, GraspLatentDDM, grasp_ldm_state_dict, None),
    "class": (JClassDDM, ClassConditionedGraspLatentDDM, class_conditioned_ldm_state_dict,
              "cls_cond"),
    "region": (JRegionDDM, RegionConditionedGraspLatentDDM, region_conditioned_ldm_state_dict,
               "region_points"),
}


def _net(kind, L: int, cond_dim: int, seed: int):
    jcls, cls, convert, cond = KINDS[kind]
    inp = _inputs(L, cond_dim, seed)
    jddm = jcls(dropout=None, latent_in_features=L, pc_latent_size=cond_dim)
    ck = {} if cond is None else {cond: inp["cls"] if kind == "class" else inp["rp"]}
    dv = jax.tree.map(np.asarray, jax.jit(jddm.init)(
        jax.random.PRNGKey(seed + 1), inp["x"], inp["t"], inp["zc"], **ck))
    ddm = cls(dropout=None, latent_in_features=L, pc_latent_size=cond_dim).eval()
    ddm.load_state_dict(convert(dv), strict=True)
    return dict(jddm=jddm, apply=jax.jit(jddm.apply), dv=dv, ddm=ddm, inp=inp, ck=ck, L=L,
                cond_dim=cond_dim)


@pytest.fixture(scope="module")
def nets():
    return {"class": _net("class", 4, 64, 0), "region": _net("region", 4, 64, 2)}


@pytest.mark.parametrize("kind", ["class", "region"])
def test_conditioned_denoisers_match_flax(nets, kind):
    """The port's modules against the flax modules, the condition kept
    (``cond_mask`` absent), and dropped on every other row (``cond_mask``
    0 there: the null condition of classifier-free guidance)."""
    m = nets[kind]
    inp = m["inp"]
    for mask in (None, inp["mask"]):
        want = m["apply"](m["dv"], inp["x"], inp["t"], inp["zc"], cond_mask=mask, **m["ck"])
        got = m["ddm"](_t(inp["x"]), _t(inp["t"]).long(), _t(inp["zc"]),
                       cond_mask=None if mask is None else _t(mask),
                       **{k: _t(v) for k, v in m["ck"].items()})
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL, err_msg=f"mask {mask}")
    # cond_mask = 0 on every row is the unconditional denoiser: the extra
    # embedding drops out
    zero = np.zeros(BG, np.float32)
    got = m["ddm"](_t(inp["x"]), _t(inp["t"]).long(), _t(inp["zc"]), cond_mask=_t(zero),
                   **{k: _t(v) for k, v in m["ck"].items()})
    plain = GraspLatentDDM.forward(m["ddm"], _t(inp["x"]), _t(inp["t"]).long(), _t(inp["zc"]))
    torch.testing.assert_close(got, plain, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["class", "region"])
def test_extra_emb_matches_jax(nets, kind):
    """``compute_extra_emb`` on the packed aux weights against the JAX
    package's on its stacked weights, and against the module's own."""
    from graspldm_tpu.models.stacked_denoiser import pack_stacked_weights

    m = nets[kind]
    dims = _denoiser_dims(m["ddm"])
    jdims = JDims(*dims)
    jw = pack_stacked_weights(m["dv"], jdims)
    w = sc.PackedNet(pack_math_weights(m["ddm"], dims), dims)
    (key, value), = m["ck"].items()
    got = compute_extra_emb(w.aux, **{key: _t(value)})
    assert got.shape == (BG, dims.emb_dim) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(j_extra_emb(jw, **{key: value})), **EMB_TOL)
    torch.testing.assert_close(got, m["ddm"].extra_emb(_t(value)), **EMB_TOL)
    assert compute_extra_emb(w.aux) is None


@pytest.mark.parametrize("L,cond_dim", [(4, 64), (16, 256)], ids=["fpc", "ppc"])
@pytest.mark.parametrize("kind", [None, "class"], ids=["uncond", "class"])
def test_full_plain_matches_pallas_full_kernel_interpret(kind, L, cond_dim):
    """The whole-network path (``fuse_stages=True``: the plain version of
    ``full_kernel`` on CPU tensors) against JAX's ``_full_kernel`` in
    interpret mode on the same weights and inputs (JAX takes the class
    embedding as ``extra_emb``; the port folds it into ``input_emb``, as
    both pipelines do); and bitwise against the port's stage chain."""
    m = _net(kind, L, cond_dim, 4)
    inp, dims = m["inp"], _denoiser_dims(m["ddm"])
    jw = pack_pallas_weights(m["dv"], JDims(*dims), dtype=jnp.float32)
    extra = None if kind is None else j_extra_emb(jw, cls_cond=inp["cls"])
    want = stacked_denoiser_pallas_apply(jw, inp["x"], inp["t"], inp["zc"], JDims(*dims),
                                         block_rows=BG, interpret=True, fuse_stages=True,
                                         extra_emb=extra)
    w = sc.PackedNet(pack_math_weights(m["ddm"], dims), dims)
    ie = compute_input_emb(w.aux, _t(inp["zc"]))
    if kind is not None:
        ie = ie + compute_extra_emb(w.aux, cls_cond=_t(inp["cls"]))[:, None, :]
    args = (w, _t(inp["x"]), _t(inp["t"]), None, ie)
    before = sc.FULL_KERNEL.launches
    got = sc.stacked_denoiser_apply(*args, fuse_stages=True)
    assert sc.FULL_KERNEL.launches == before  # a CPU tensor launches nothing
    assert got.shape == (BG, 1, L)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    chain = sc.stacked_denoiser_apply(*args, fuse_stages=False)
    torch.testing.assert_close(got, chain, rtol=0, atol=0)
    # and the module itself
    mod = m["ddm"](_t(inp["x"]), _t(inp["t"]).long(), _t(inp["zc"]),
                   **{k: _t(v) for k, v in m["ck"].items()})
    np.testing.assert_allclose(_np(got), _np(mod), **TOL)


def test_full_plain_is_the_stage_chain_in_bf16():
    """``full_plain`` rounds to bf16 where the chain of ``stage_plain`` and
    ``final_plain`` stores its activations: bitwise equal to it."""
    torch.manual_seed(0)
    ddm = ClassConditionedGraspLatentDDM(dropout=None).eval()
    dims = _denoiser_dims(ddm)
    w = sc.PackedNet(pack_math_weights(ddm, dims), dims, torch.bfloat16)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(BG, dims.seq_len * dims.cins[0], generator=g).to(torch.bfloat16)
    emb = torch.randn(BG, dims.cond_channels * dims.emb_dim, generator=g).to(torch.bfloat16)
    h = x
    for i in range(len(dims.block_channels)):
        h = sc.stage_plain(w, i, h, emb)
    want = sc.final_plain(w, h, emb)
    got = sc.full_apply(w, x, emb)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_conditioned_weights_pack_into_aux(nets):
    """The extra embedding's weights ride in the float32 ``aux`` set (they
    run in plain PyTorch), not in the kernels' flat buffer; a conditioned
    denoiser packs float32 even when asked for bf16 elsewhere."""
    for kind, keys in (("class", ("cls_w", "cls_b")),
                       ("region", ("region_w1", "region_b1", "region_w2", "region_b2"))):
        ddm = nets[kind]["ddm"]
        w = sc.PackedNet(pack_math_weights(ddm, _denoiser_dims(ddm)), _denoiser_dims(ddm))
        assert all(k in w.aux and k not in w.w for k in keys)
        assert all(w.aux[k].dtype == torch.float32 for k in keys)
        assert ddm.dtype is None and ddm.conditioning == kind
