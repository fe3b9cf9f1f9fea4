"""Port parity: the LDM denoiser, its kernel path and the sampler of
``graspldm_tpu_torch`` against the JAX package on the CPU.

The denoiser runs at the flagship widths (L = 4, channels 32/64/128/256,
3 conditioning channels of 64) with BG = 8 rows, as
``tests/test_fused_denoiser.py`` does. Its weights are initialised by JAX and
carried into the port by ``graspldm_tpu_torch.utils.convert``; inputs come
from ``np.random.default_rng``, and the sampler's x_T and DDPM noise are
JAX's own draws. On the CPU every kernel wrapper of the port runs its plain
PyTorch version, which is what these tests hold against the flax module and
against the Pallas kernels in interpret mode.

Tolerances (float32): atol 2e-4 / rtol 5e-4 where XLA and torch reorder
sums (the JAX package's precedent for its kernels,
``tests/test_fused_denoiser.py:96``); 5e-4 for samplers, whose steps carry
such differences forward (``test_fused_denoiser.py:322``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graspldm_tpu.diffusion import GaussianDiffusion1D as JGaussian
from graspldm_tpu.diffusion.schedules import DiffusionSchedule as JSchedule
from graspldm_tpu.models import GraspLatentDDM as JDDM
from graspldm_tpu.models.pallas_sampler import fused_sample as j_fused_sample
from graspldm_tpu.models.stacked_denoiser import FLAGSHIP_DIMS as J_DIMS
from graspldm_tpu.models.stacked_denoiser import compute_input_emb as j_input_emb
from graspldm_tpu.models.stacked_pallas import (
    pack_pallas_weights,
    stacked_denoiser_pallas_apply,
)
from graspldm_tpu.utils.torch_convert import grasp_ldm_variables_from_torch

from graspldm_tpu_torch.diffusion import DiffusionSchedule, GaussianDiffusion1D
from graspldm_tpu_torch.models import GraspLatentDDM
from graspldm_tpu_torch.models.cuda_sampler import fused_sample
from graspldm_tpu_torch.models.stacked_cuda import PackedNet, stacked_denoiser_apply
from graspldm_tpu_torch.models.stacked_denoiser import (
    FLAGSHIP_DIMS,
    compute_input_emb,
    pack_math_weights,
)
from graspldm_tpu_torch.utils.convert import grasp_ldm_state_dict

KERNEL_TOL = dict(atol=2e-4, rtol=5e-4)
SAMPLER_TOL = dict(atol=5e-4, rtol=5e-4)
BG = 8
SCHEDULE = dict(num_steps=1000, beta_start=5e-5, beta_end=1e-3)  # the flagship's


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module")
def m():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(BG, 1, 4)).astype(np.float32)
    t = (np.arange(BG) * 127 % 1000).astype(np.int32)
    zc = rng.normal(size=(BG, 3, 64)).astype(np.float32)
    jddm = JDDM(dropout=None)
    dv = jax.tree.map(np.asarray, jax.jit(jddm.init)(jax.random.PRNGKey(1), x, t, zc))
    ddm = GraspLatentDDM(dropout=None).eval()
    ddm.load_state_dict(grasp_ldm_state_dict(dv), strict=True)
    packed = PackedNet(pack_math_weights(ddm, FLAGSHIP_DIMS), FLAGSHIP_DIMS)
    return dict(jddm=jddm, dv=dv, apply=jax.jit(jddm.apply), ddm=ddm, packed=packed,
                x=x, t=t, zc=zc)


def test_weight_bridge_round_trips_through_torch_convert(m):
    """JAX variables -> port state_dict -> ``graspldm_tpu.utils.torch_convert``
    gives back the JAX variables bit for bit."""
    sd = {k: v.numpy() for k, v in m["ddm"].state_dict().items()}
    back = grasp_ldm_variables_from_torch(sd, num_blocks=4)
    flat_a, tree_a = jax.tree.flatten(back)
    flat_b, tree_b = jax.tree.flatten(m["dv"])
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_denoiser_forward_matches_flax(m):
    want = np.asarray(m["apply"](m["dv"], m["x"], m["t"], m["zc"]))
    with torch.no_grad():
        got = m["ddm"](_t(m["x"]), _t(m["t"]).long(), _t(m["zc"]))
    np.testing.assert_allclose(_np(got), want, **KERNEL_TOL)


def test_stage_and_final_plain_path_matches_pallas_interpret(m):
    """The port's denoiser kernel path (stage/final plain versions at L=4)
    against ``stacked_denoiser_pallas_apply`` in interpret mode and against
    the flax module."""
    got = stacked_denoiser_apply(m["packed"], _t(m["x"]), _t(m["t"]), _t(m["zc"]))
    jw = pack_pallas_weights(m["dv"], J_DIMS, dtype=jnp.float32)
    want = np.asarray(stacked_denoiser_pallas_apply(
        jw, m["x"], m["t"], m["zc"], J_DIMS, block_rows=8, interpret=True))
    np.testing.assert_allclose(_np(got), want, **KERNEL_TOL)
    flax = np.asarray(m["apply"](m["dv"], m["x"], m["t"], m["zc"]))
    np.testing.assert_allclose(_np(got), flax, **KERNEL_TOL)


def _jax_draws(key, sampler: str, n_steps: int, bg: int, d: int):
    """x_T and the DDPM per-step noise exactly as ``GaussianDiffusion1D.sample``
    draws them (``gaussian.py:120-142``); ``n_steps`` is the grid's length."""
    k_init, k_loop = jax.random.split(key)
    x_T = np.asarray(jax.random.normal(k_init, (bg, 1, d)))
    if sampler == "ddim":
        return x_T, None
    noise = []
    for _ in range(n_steps):
        k_loop, k_noise = jax.random.split(k_loop)
        noise.append(np.asarray(jax.random.normal(k_noise, (bg, 1, d))))
    return x_T, np.stack(noise)


# 5 divides T = 1000; 3 does not, and the grid then has 4 steps of stride 333
@pytest.mark.parametrize("sampler,steps", [("ddim", 5), ("ddpm", 5), ("ddim", 3), ("ddpm", 3)])
def test_sampler_matches_gaussian_sample_with_flax_denoiser(m, sampler, steps):
    """The sampler kernel's plain version (all steps) and the port's
    Python-loop ``GaussianDiffusion1D.sample`` against JAX's scan sampler
    over the flax denoiser, fed JAX's own x_T and noise."""
    jdiff = JGaussian(schedule=JSchedule.create(**SCHEDULE), n_dims=4)
    key = jax.random.PRNGKey(9)
    want, _ = jdiff.sample(
        lambda x, t, z: m["apply"](m["dv"], x, t, z), key, batch_size=BG, z_cond=m["zc"],
        num_inference_steps=steps, sampler=sampler)
    diff = GaussianDiffusion1D(schedule=DiffusionSchedule.create(**SCHEDULE), n_dims=4)
    n_grid = len(diff.schedule.timestep_grid(steps))
    x_T, noise = _jax_draws(key, sampler, n_grid, BG, 4)

    w = m["packed"]
    got = fused_sample(
        w, diff.schedule, compute_input_emb(w.aux, _t(m["zc"])), _t(x_T[:, 0]),
        num_inference_steps=steps, sampler=sampler,
        noise=None if noise is None else _t(noise[:, :, 0]))
    assert got.shape == (BG, 1, 4)
    np.testing.assert_allclose(_np(got), np.asarray(want), **SAMPLER_TOL)

    with torch.no_grad():
        loop = diff.sample(
            lambda x, t, z: m["ddm"](x, t, z), BG, z_cond=_t(m["zc"]),
            num_inference_steps=steps, sampler=sampler, x_T=_t(x_T),
            noise=None if noise is None else _t(noise))
    np.testing.assert_allclose(_np(loop), np.asarray(want), **SAMPLER_TOL)


@pytest.mark.parametrize("sampler", ["ddim", "ddpm"])
def test_sampler_matches_pallas_megakernel_interpret(m, sampler):
    """The sampler kernel's plain version against the TPU kernel it
    replaces (``pallas_sampler.py:_mega_kernel``, whole-scan branch) in
    interpret mode, over a ragged row block (BG = 6, block_rows = 4). The
    step count divides T: the JAX megakernel runs S grid steps where the
    grid has more (ROADMAP.md, Faults)."""
    bg, steps, key = 6, 4, jax.random.PRNGKey(4)
    schedule = JSchedule.create(**SCHEDULE)
    jw = pack_pallas_weights(m["dv"], J_DIMS, dtype=jnp.float32)
    want, _ = j_fused_sample(
        jw, J_DIMS, schedule, j_input_emb(jw, m["zc"][:bg]), key, batch_size=bg,
        num_inference_steps=steps, sampler=sampler, block_rows=4, interpret=True,
        fuse_scan=True)
    x_T, noise = _jax_draws(key, sampler, steps, bg, 4)
    w = m["packed"]
    got = fused_sample(
        w, DiffusionSchedule.create(**SCHEDULE), compute_input_emb(w.aux, _t(m["zc"][:bg])),
        _t(x_T[:, 0]), num_inference_steps=steps, sampler=sampler,
        noise=None if noise is None else _t(noise[:, :, 0]))
    np.testing.assert_allclose(_np(got), np.asarray(want), **SAMPLER_TOL)


def test_bf16_plain_path_stays_near_fp32(m):
    """bfloat16 weights and activations (the chip's configuration) through
    the plain stage/final path: within the JAX package's own bf16 bound for
    its stacked path (``test_fused_denoiser.py:69``)."""
    args = (_t(m["x"]), _t(m["t"]), _t(m["zc"]))
    f32 = stacked_denoiser_apply(m["packed"], *args)
    math = pack_math_weights(m["ddm"], FLAGSHIP_DIMS)
    bf16 = stacked_denoiser_apply(PackedNet(math, FLAGSHIP_DIMS, torch.bfloat16), *args)
    assert bf16.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(bf16.float()), _np(f32), atol=0.15, rtol=0.1)
