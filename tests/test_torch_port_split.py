"""The exact bf16 split of the float32 tensor-core products and, on the
card, the tensor-core network bodies against their plain versions.

``full_kernel<float>`` runs its products on the tensor cores as bf16
products (``csrc/tc_blocks.cuh``): every float32 weight and activation is
split exactly into three bf16 parts (``stacked_cuda.bf16_parts`` at packing
time, ``split3`` in the kernel), and the six products ``a_i * w_j`` with
``i + j <= 4`` run. The CPU tests hold the split (exact, bitwise), its
fragment-ordered copies in the float32 pack, and, in float64, that the six
products compute a float32 product while the five of ``mm_chain_kernel``'s
f32 form (two activation parts) do not.

This file imports torch and numpy only (no JAX), so the ``cuda`` tests run
on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_port_split.py

Without a card they skip.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from graspldm_tpu_torch.inference.pipeline import _denoiser_dims
from graspldm_tpu_torch.models import GraspLatentDDM
from graspldm_tpu_torch.models import stacked_cuda as sc
from graspldm_tpu_torch.models.stacked_denoiser import pack_math_weights


def _normals(shape, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _assert_exact_split(x: torch.Tensor) -> None:
    """``bf16_parts(x)``: three bf16 values whose sum is ``x`` bitwise."""
    parts = sc.bf16_parts(x)
    assert parts.shape == (3, *x.shape) and parts.dtype == torch.bfloat16
    p = parts.double()
    assert torch.equal(p[0] + p[1] + p[2], x.double())
    # the parts shrink by bf16's 8 bits each (the part after a zero is zero)
    assert (p[1].abs() <= p[0].abs() * 2.0 ** -8).all()
    assert (p[2].abs() <= p[1].abs() * 2.0 ** -8).all()


# magnitudes: normals; zeros; every |x| in [2^e, 2^(e+1)) with a random
# sign and significand for e from -100 to 100; and exponents drawn from
# [-100, 100] at random
SCALES = ["normal", "zeros", -100, -60, -20, 0, 20, 60, 100, "uniform exponent"]


def _values(kind, seed: int) -> torch.Tensor:
    x = _normals((64, 96), seed)
    if kind == "normal":
        return x
    if kind == "zeros":
        return torch.zeros_like(x)
    rng = np.random.default_rng(seed + 1)
    e = rng.integers(-100, 101, x.shape) if kind == "uniform exponent" else np.full(x.shape, kind)
    sig = (rng.random(x.shape) + 1.0) * np.where(rng.random(x.shape) < 0.5, -1.0, 1.0)
    return torch.from_numpy(np.ldexp(sig, e).astype(np.float32))


@pytest.mark.parametrize("kind", SCALES)
def test_weight_split_is_exact(kind):
    """The packing-time split of float32 weights is exact at every
    magnitude float32 takes between 2^-100 and 2^100, and of zeros."""
    _assert_exact_split(_values(kind, 11))


def _network_activations() -> list:
    """Every A operand the float32 network's k3 products take on random
    inputs: the plain version's conv and projection inputs (GroupNorm,
    FiLM, SiLU and residual outputs), recorded as ``full_plain`` runs."""
    torch.manual_seed(0)
    ddm = GraspLatentDDM(dropout=None).eval()
    dims = _denoiser_dims(ddm)
    w = sc.PackedNet(pack_math_weights(ddm, dims), dims)
    seen = []
    conv3 = sc._conv3

    def record(x, W, b):
        seen.append(x.detach().clone())
        return conv3(x, W, b)

    x = _normals((8, dims.seq_len * dims.cins[0]), 3)
    emb = _normals((8, dims.cond_channels * dims.emb_dim), 4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sc, "_conv3", record)
        sc.full_plain(w, x, emb)
    return seen


@pytest.mark.parametrize("scale", [0, -60, -30, 30, 60])
def test_activation_split_is_exact(scale):
    """The kernel's split of the activations (``split3``: the same three
    roundings, in float32, as ``bf16_parts``) is exact on the network's own
    activations, and on them scaled by 2^-60 to 2^60 (every nonzero
    magnitude then stays within [2^-100, 2^100])."""
    acts = _network_activations()
    assert len(acts) == 9 * 2 + 4 and all(torch.isfinite(a).all() for a in acts)
    for a in acts:
        a = a * 2.0 ** scale
        mag = a.abs()[a != 0]
        assert mag.min() >= 2.0 ** -100 and mag.max() < 2.0 ** 100
        _assert_exact_split(a)


def _unfragment(frag: torch.Tensor, taps: int, Ck: int, N: int) -> torch.Tensor:
    """The padded [taps * Ck16, N16] matrix a tc_fragments copy holds, read
    back through the lane map csrc/tc_blocks.cuh loads it by: lane 4g + t of
    column pair p at k-step s holds, for n-tile j, W[16s + 8q + 2t + h,
    16p + 8j + g] at position 4j + 2q + h of its 8 values."""
    ck16, n16 = (Ck + 15) // 16 * 16, (N + 15) // 16 * 16
    KS, NP = taps * ck16 // 16, n16 // 16
    out = torch.full((taps * ck16, n16), float("nan"), dtype=torch.float64)
    vals = frag.double().reshape(KS, NP, 32, 8)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for v in range(8):
            j, q, h = v // 4, (v // 2) % 2, v % 2
            k = torch.arange(KS)[:, None] * 16 + 8 * q + 2 * t + h
            n = torch.arange(NP)[None, :] * 16 + 8 * j + g
            out[k, n] = vals[:, :, lane, v]
    return out


def _split_frags(W: torch.Tensor, taps: int) -> torch.Tensor:
    """The float32 pack's copy of one product: the fragments of its three
    parts, one whole copy after another, as bf16."""
    return torch.cat([sc.tc_fragments(p, taps) for p in sc.bf16_parts(W)]).to(torch.bfloat16)


# (taps, Ck, N) as test_torch_port_kernels.TC_SHAPES: the narrow first stage,
# the flagship convs and projections, wqkv and wo, widths off the 16 grid
TC_SHAPES = [(3, 4, 4), (3, 4, 32), (3, 32, 64), (3, 128, 256), (3, 256, 256), (1, 4, 384),
             (1, 128, 4), (3, 8, 16), (1, 24, 40)]


@pytest.mark.parametrize("taps,Ck,N", TC_SHAPES)
def test_split_fragments_round_trip_to_the_math_form(taps, Ck, N):
    """The three fragment-ordered parts of a float32 weight, each read back
    through the lane map, sum to the math form exactly, with zeros in
    every padded row and column; the part stride is one copy's length."""
    W = _normals((taps * Ck, N), taps * 1000 + Ck + N) * 0.05
    frag = _split_frags(W, taps)
    ck16, n16 = (Ck + 15) // 16 * 16, (N + 15) // 16 * 16
    P = taps * ck16 * n16
    assert frag.numel() == 3 * P
    parts = [_unfragment(frag[k * P:(k + 1) * P], taps, Ck, N) for k in range(3)]
    assert not any(torch.isnan(p).any() for p in parts)
    padded = (parts[0] + parts[1] + parts[2]).reshape(taps, ck16, n16)
    assert torch.equal(padded[:, :Ck, :N].reshape(taps * Ck, N), W.double())
    for p in parts:
        p = p.reshape(taps, ck16, n16)
        assert not p[:, Ck:].any() and not p[:, :, N:].any()


@pytest.fixture(scope="module")
def dens():
    torch.manual_seed(0)
    ddm = GraspLatentDDM(dropout=None).eval()
    ddm16 = GraspLatentDDM(latent_in_features=16, pc_latent_size=256, dropout=None).eval()
    return {L: (pack_math_weights(m, _denoiser_dims(m)), _denoiser_dims(m))
            for L, m in ((4, ddm), (16, ddm16))}


@pytest.mark.parametrize("L", [4, 16])
def test_fp32_pack_carries_the_split_table(dens, L):
    """A float32 PackedNet keeps the math form as it was (``math_flat``,
    the views ``w``) and appends, for every tensor-core product, the three
    parts' fragments (bf16 bits two to a float32 element), pointed at by the
    layout's tensor-core table: one entry a product, the parts contiguous."""
    math, dims = dens[L]
    w = sc.PackedNet(math, dims, torch.float32)
    bf = sc.PackedNet(math, dims, torch.bfloat16)
    assert w.n_math == bf.n_math
    for k, v in w.w.items():
        assert torch.equal(v, math[k]), k
    assert torch.equal(w.math_flat.to(torch.bfloat16), bf.math_flat)
    n = len(dims.block_channels)
    table = w.layout[int(w.layout[sc.N_TC]):].tolist()
    assert len(table) == (n + 1) * sc.TC_REC
    slots = {f"b{i}_{s}": i * sc.TC_REC + j for i in range(n) for j, s in enumerate(sc.TC_SLOTS)}
    slots.update(final_w1=n * sc.TC_REC, final_w2=n * sc.TC_REC + 1)
    end = w.n_math
    for name, (taps, W) in sc._tc_products(math, dims).items():
        want = _split_frags(W, taps)
        off = table[slots[name]]
        assert off == end and off % 4 == 0, name  # in order, 16-byte aligned
        got = w.flat[off: off + want.numel() // 2].view(torch.bfloat16)
        assert torch.equal(got, want), name
        end += want.numel() // 2
    assert end == w.flat.numel()


def _k3_operands(seed: int, R: int, L: int, Ck: int, N: int):
    """A k3 conv's operands: the im2col of random activations [R, L, Ck]
    (zero padded at the row ends), ``[R*L, 3*Ck]``, and a weight ``[3*Ck,
    N]`` at a conv's initial scale."""
    x = _normals((R, L, Ck), seed)
    xp = F.pad(x, (0, 0, 1, 1))
    A = torch.cat([xp[:, t:t + L] for t in range(3)], dim=-1).reshape(R * L, 3 * Ck)
    return A, _normals((3 * Ck, N), seed + 1) * (3 * Ck) ** -0.5


@pytest.mark.parametrize("seed,L,Ck,N", [(0, 4, 256, 256), (1, 4, 128, 256), (2, 16, 128, 256),
                                         (3, 16, 64, 128), (4, 4, 32, 64)])
def test_six_products_hold_float32_and_five_do_not(seed, L, Ck, N):
    """In float64 (where every bf16 x bf16 product and their sums are
    exact): the six kept products of the split activations and weights are
    within 2^-22 of max|ref| of the float64 product, the float32 function's
    own accuracy; the five of ``mm_chain_kernel``'s f32 form, whose
    activations have two parts (x*x has 16 significant bits there, a
    network activation 24), are not."""
    A, W = _k3_operands(seed, 9, L, Ck, N)
    ref = A.double() @ W.double()
    ap, wp = sc.bf16_parts(A).double(), sc.bf16_parts(W).double()
    six = sum(ap[i] @ wp[j] for i in range(3) for j in range(3) if i + j <= 2)
    five = sum(ap[i] @ wp[j] for i in range(2) for j in range(3) if i + j <= 2)
    top = ref.abs().max().item()
    six_err = (six - ref).abs().max().item() / top
    five_err = (five - ref).abs().max().item() / top
    assert six_err <= 2.0 ** -22, six_err
    assert five_err > 2.0 ** -22, five_err


# ---------------------------------------------------------------------------
# on the card: the tensor-core network bodies against their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card, see the module docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


# chip_smoke.TOL_FP32 and TOL_BF16, relative to max(1, max|ref|): float32
# sums in another order (the split's products are exact); bf16 one-ulp
# rounding flips next to a boundary and what follows them
TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -5}
# flagship widths and two narrow models (8-wide stages and the init conv's
# L channels take the value-by-value path on A)
CHANNELS = [(32, 64, 128, 256), (8, 16), (16, 32)]


def _pack(channels, L: int, dtype, dev):
    torch.manual_seed(len(channels) + L)
    ddm = GraspLatentDDM(block_channels=channels, latent_in_features=L,
                         pc_latent_size=256 if L == 16 else 64, dropout=None).eval()
    dims = _denoiser_dims(ddm)
    return sc.PackedNet(pack_math_weights(ddm, dims), dims, dtype, dev)


def _close(got, ref, dtype) -> None:
    assert bool(torch.isfinite(got.float()).all())
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * max(1.0, ref.float().abs().max().item()), err


@pytest.mark.cuda
@pytest.mark.parametrize("BG", [37, 1021])
@pytest.mark.parametrize("channels", CHANNELS)
@pytest.mark.parametrize("L", [4, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_kernel_on_the_tensor_cores_matches_plain_on_card(cuda, dtype, L, channels, BG):
    """``full_kernel`` in bf16 and float32 (the exact split) against
    ``full_plain`` at L = 4 and 16, flagship and narrow widths, ragged BG."""
    w = _pack(channels, L, dtype, cuda)
    d = w.dims
    g = torch.Generator(device=cuda).manual_seed(21)
    x = torch.randn(BG, L * d.cins[0], generator=g, device=cuda).to(dtype)
    emb = torch.randn(BG, d.cond_channels * d.emb_dim, generator=g, device=cuda).to(dtype)
    before = sc.FULL_KERNEL.launches
    got = sc.full_apply(w, x, emb)
    torch.cuda.synchronize()
    assert sc.FULL_KERNEL.launches == before + 1
    assert got.shape == (BG, L) and got.dtype == dtype
    _close(got, sc.full_plain(w, x, emb), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("BG", [37, 1021])
@pytest.mark.parametrize("channels", CHANNELS)
@pytest.mark.parametrize("L", [4, 16])
def test_bf16_stage_kernel_on_the_tensor_cores_matches_plain_on_card(cuda, L, channels, BG):
    """``stage_kernel<bf16>`` against ``stage_plain`` for every stage, at
    L = 4 and 16 (the decoder's), flagship and narrow widths, ragged BG."""
    w = _pack(channels, L, torch.bfloat16, cuda)
    d = w.dims
    g = torch.Generator(device=cuda).manual_seed(22)
    emb = torch.randn(BG, d.cond_channels * d.emb_dim, generator=g, device=cuda).to(torch.bfloat16)
    for i, C in enumerate(d.cins):
        x = torch.randn(BG, L * C, generator=g, device=cuda).to(torch.bfloat16)
        before = sc.STAGE_KERNEL.launches
        got = sc.stage_apply(w, i, x, emb)
        torch.cuda.synchronize()
        assert sc.STAGE_KERNEL.launches == before + 1
        assert got.shape == (BG, L * d.block_channels[i])
        _close(got, sc.stage_plain(w, i, x, emb), torch.bfloat16)
