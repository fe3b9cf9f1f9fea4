"""Port parity: the grasp VAE of ``graspldm_tpu_torch`` (PVCNN point-cloud
encoder, grasp encoder, decoder and its kernel path) against the JAX package
on the CPU.

The decoder keeps the flagship widths (L = 16, channels 32/64/128/256). The
point-cloud encoder is cut to 32 points, ``pc_scale_channels`` 0.25 and
``pc_scale_voxel_resolution`` 0.25 (channels 16/32/256/512, voxel grids 8^3
and 4^3), as ``tests/test_fused_denoiser.py:681`` cuts it, to keep the flax
init and the XLA compiles cheap. Weights are initialised by JAX and carried
into the port by ``graspldm_tpu_torch.utils.convert``; inputs come from
``np.random.default_rng``.

Tolerance (float32): atol 2e-4 / rtol 5e-4, the JAX package's precedent
where XLA and torch reorder sums (``tests/test_fused_denoiser.py:96``).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graspldm_tpu.flagship import FlagshipConfig as JConfig
from graspldm_tpu.flagship import build_flagship as j_build
from graspldm_tpu.models import fast_decoder as jfd
from graspldm_tpu.utils.torch_convert import grasp_cvae_variables_from_torch

from graspldm_tpu_torch.flagship import FlagshipConfig, build_flagship
from graspldm_tpu_torch.models import fast_decoder as tfd
from graspldm_tpu_torch.utils.convert import grasp_cvae_state_dict

TOL = dict(atol=2e-4, rtol=5e-4)
CFG = dict(pc_num_points=32, pc_scale_channels=0.25, pc_scale_voxel_resolution=0.25,
           dropout=None)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module")
def m():
    rng = np.random.default_rng(0)
    jvae = j_build(JConfig(**CFG))[0]
    pc = rng.normal(0.0, 0.5, size=(2, CFG["pc_num_points"], 3)).astype(np.float32)
    grasps = rng.normal(size=(4, 7)).astype(np.float32)
    vv = jax.tree.map(np.asarray, jax.jit(jvae.init)(jax.random.PRNGKey(0), pc, grasps))
    vae = build_flagship(FlagshipConfig(**CFG), device="cpu")[0]
    vae.load_state_dict(grasp_cvae_state_dict(vv), strict=True)
    return dict(jvae=jvae, vv=vv, vae=vae, pc=pc, grasps=grasps, rng=rng)


def _japply(m, method):
    return jax.jit(functools.partial(m["jvae"].apply, method=method))


def test_weight_bridge_round_trips_through_torch_convert(m):
    """JAX variables (params + BatchNorm stats) -> port state_dict ->
    ``graspldm_tpu.utils.torch_convert`` gives back the JAX variables bit for
    bit."""
    sd = {k: v.numpy() for k, v in m["vae"].state_dict().items()}
    back = grasp_cvae_variables_from_torch(sd, num_core_blocks=4)
    flat_a, tree_a = jax.tree.flatten(back)
    flat_b, tree_b = jax.tree.flatten(m["vv"])
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_encode_pc_matches_flax(m):
    """PVCNN: voxelize, Conv3d/GroupNorm/SE, devoxelize, SharedMLPs with
    BatchNorm in eval mode (running statistics)."""
    want = np.asarray(_japply(m, "encode_pc")(m["vv"], m["pc"]))
    with torch.no_grad():
        got = m["vae"].encode_pc(_t(m["pc"]))
    assert got.shape == (2, 3, 64)
    np.testing.assert_allclose(_np(got), want, **TOL)


def test_encode_grasp_matches_flax(m):
    zc = np.random.default_rng(1).normal(size=(4, 3, 64)).astype(np.float32)
    want = _japply(m, "encode_grasp")(m["vv"], m["grasps"], zc)
    with torch.no_grad():
        got = m["vae"].encode_grasp(_t(m["grasps"]), _t(zc))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)


def test_decoder_module_and_kernel_path_match_flax(m):
    """``GraspCVAE.decode`` and the port's decoder kernel path (stage/final
    plain versions at L = 16, four stages and the final block) against
    flax's decode and the JAX decoder's Pallas kernels in interpret mode."""
    rng = np.random.default_rng(3)
    z_h = rng.normal(size=(8, 4)).astype(np.float32)
    z_pc = rng.normal(size=(8, 3, 64)).astype(np.float32)
    want = _japply(m, "decode")(m["vv"], z_h, z_pc)
    jdims = jfd.decoder_dims_for(m["jvae"])
    jw = jfd.pack_decoder_weights(m["vv"], jdims, dtype=jnp.float32)
    pallas = jax.jit(lambda w, a, b: jfd.decoder_fast_apply(
        w, a, b, jdims, block_rows=8, interpret=True))(jw, z_h, z_pc)

    vae = m["vae"]
    dims = tfd.decoder_dims_for(vae)
    assert dims.seq_len == 16 and dims.cins == (16, 32, 64, 128)
    kernel_path = tfd.decoder_fast_apply(tfd.pack_decoder_weights(vae, dims), _t(z_h), _t(z_pc))
    with torch.no_grad():
        module = vae.decode(_t(z_h), _t(z_pc))
    assert len(kernel_path) == len(module) == len(want) == len(pallas) == 2
    for got_k, got_m, a, b in zip(kernel_path, module, want, pallas):
        np.testing.assert_allclose(_np(got_m), np.asarray(a), **TOL)
        np.testing.assert_allclose(_np(got_k), np.asarray(a), **TOL)
        np.testing.assert_allclose(_np(got_k), np.asarray(b), **TOL)
