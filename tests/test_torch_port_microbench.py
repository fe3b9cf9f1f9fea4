"""Port parity, micro-benchmarks: the chains of ``tools/bench_mm.py``,
``tools/bench_silu.py`` and ``tools/bench_repeat.py`` against the port's
``graspldm_tpu_torch.tools`` on the CPU, and the port's entry points.

Each JAX form runs through its tool's own ``make_kernel(form)`` under
``pl.pallas_call(..., interpret=True)`` (R = 64 rows in blocks of 32; SiLU
width 256); the port's form is its plain PyTorch version (a CPU tensor
takes it). Both get the same inputs, drawn with ``np.random.default_rng``
and rounded to bf16.

Tolerances, from a measurement on the CPU (all 9 forms):
* bench_mm: 1e-6 of max|ref|. Both compute the same exact products and sum
  them in float32 in another order; measured 0 (f32), 1.9e-7 (bf16) and
  2.3e-7 (split).
* bench_silu: one bf16 ulp of max|ref|. Every op rounds in the same place
  in both packages; measured bitwise equal in all three forms (0 of 16384
  entries differ). The two frameworks' float32 exp may differ in its last
  bit on another CPU, which can move a bf16 rounding by one ulp; the
  forms themselves lie 6 such ulps apart (bf16exp against f32, checked).
* bench_repeat: bitwise (0 ulps). Every product and sum is one rounding of
  an exact float32 result, in ``functools.reduce``'s order in both.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import tools.bench_mm as jmm  # noqa: E402
import tools.bench_repeat as jrep  # noqa: E402
import tools.bench_silu as jsilu  # noqa: E402

from graspldm_tpu_torch.tools import bench_mm, bench_repeat, bench_silu  # noqa: E402
from graspldm_tpu_torch.tools import bf16_bits  # noqa: E402
from graspldm_tpu_torch.utils.profiling import timeit  # noqa: E402

R, RB, SILU_W = 64, 32, 256
TOOLS = {"mm": bench_mm, "silu": bench_silu, "repeat": bench_repeat}


def _bf16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to bf16 (as float32), through JAX."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _torch_bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def _inputs(tool: str, rows: int = R, seed: int = 0):
    """Numpy float32 inputs holding bf16 values: (x,) or (s, v)."""
    rng = np.random.default_rng(seed)
    if tool == "mm":
        return (_bf16(rng.standard_normal((rows, jmm.K))),)
    if tool == "silu":  # the tool's inputs: normals rounded to bf16, times 3 in bf16
        return (_bf16(_bf16(rng.standard_normal((rows, SILU_W))) * 3.0),)
    return (_bf16(rng.standard_normal((rows, jrep.L * jrep.H))),
            _bf16(rng.standard_normal((rows, jrep.L * jrep.hd))))


def _jax_form(tool: str, form: str, arrays) -> np.ndarray:
    spec = lambda w: pl.BlockSpec((RB, w), lambda i: (i, 0))  # noqa: E731
    whole = lambda a, b: pl.BlockSpec((a, b), lambda i: (0, 0))  # noqa: E731
    if tool == "mm":
        pf, pb = bench_mm.make_pool()
        args = (jnp.asarray(arrays[0], jnp.bfloat16), jnp.asarray(pf.numpy()),
                jnp.asarray(pf.numpy(), jnp.bfloat16))
        in_specs = [spec(jmm.K), whole(jmm.K, jmm.N), whole(jmm.K, jmm.N)]
        out = jax.ShapeDtypeStruct((R, jmm.N), jnp.float32)
        out_spec, kern = spec(jmm.N), jmm.make_kernel(form)
    elif tool == "silu":
        args = (jnp.asarray(arrays[0], jnp.bfloat16),)
        in_specs, out_spec = [spec(SILU_W)], spec(SILU_W)
        out = jax.ShapeDtypeStruct((R, SILU_W), jnp.bfloat16)
        kern = jsilu.make_kernel(form)
    else:
        lh, lhd = jrep.L * jrep.H, jrep.L * jrep.hd
        args = (jnp.asarray(arrays[0], jnp.bfloat16), jnp.asarray(arrays[1], jnp.bfloat16),
                jrep._qbcast())
        in_specs = [spec(lh), spec(lhd), whole(lh, lhd)]
        out = jax.ShapeDtypeStruct((R, jrep.hd), jnp.bfloat16)
        out_spec, kern = spec(jrep.hd), jrep.make_kernel(form)
    fn = pl.pallas_call(kern, grid=(R // RB,), in_specs=in_specs, out_specs=out_spec,
                        out_shape=out, interpret=True)
    return np.asarray(fn(*args)).astype(np.float32)


def _port_form(tool: str, form: str, arrays) -> torch.Tensor:
    """The port's chain through its wrapper (a CPU tensor: the plain version)."""
    ts = [_torch_bf16(a) for a in arrays]
    if tool == "mm":
        return bench_mm.mm_chain_apply(ts[0], *bench_mm.make_pool(), form)
    if tool == "silu":
        return bench_silu.silu_chain_apply(ts[0], form)
    return bench_repeat.bcast_chain_apply(ts[0], ts[1], bench_repeat.qbcast(), form)


def _ulp(top: float) -> float:
    """One bf16 ulp at magnitude ``top``."""
    return 2.0 ** (np.floor(np.log2(top)) - 7)


CASES = [("mm", f) for f in bench_mm.FORMS] + [("silu", f) for f in bench_silu.FORMS] \
    + [("repeat", f) for f in bench_repeat.FORMS]


@pytest.mark.parametrize("tool,form", CASES)
def test_port_form_matches_jax_form(tool, form):
    arrays = _inputs(tool)
    want = _jax_form(tool, form, arrays)
    got = _port_form(tool, form, arrays).float().numpy()
    assert got.shape == want.shape
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    if tool == "mm":
        assert err <= 1e-6 * top, (err, top)
    elif tool == "silu":
        assert err <= _ulp(top), (err, _ulp(top))
    else:
        np.testing.assert_array_equal(got, want)


def test_silu_limit_separates_the_forms():
    """The one-ulp limit of the SiLU parity test is far below how far the
    bf16 op-by-op form lies from the f32 form (JAX's own outputs)."""
    arrays = _inputs("silu")
    f32, bf16exp = (_jax_form("silu", f, arrays) for f in ("f32", "bf16exp"))
    assert np.abs(bf16exp - f32).max() >= 4 * _ulp(float(np.abs(f32).max()))


def test_chain_multiplier_rounds_to_one_in_both_packages():
    """bf16(0.999) is 1.0: the tools' reps compute equal products, which is
    why the kernels take the multiplier at run time."""
    assert float(jnp.float32(0.999).astype(jnp.bfloat16)) == 1.0
    assert float((jnp.ones((1,), jnp.bfloat16) * 0.999)[0]) == 1.0  # the weak-typed y * 0.999
    assert float(torch.tensor(0.999, dtype=torch.bfloat16)) == 1.0
    assert bf16_bits(bench_mm.MULT) == bf16_bits(bench_silu.MULT) == 0x3F80
    assert bf16_bits(bench_repeat.DECAY) == 0x3F00 and bf16_bits(bench_repeat.ZERO) == 0


@pytest.mark.parametrize("tool", ["mm", "silu", "repeat"])
def test_ragged_rows_are_all_computed(tool):
    """R = 67 (not a multiple of any block): every row comes out, the first
    64 equal the R = 64 result and the last 3 their own chain's."""
    form = TOOLS[tool].FORMS[1]
    full = _inputs(tool, 67, seed=5)
    got = _port_form(tool, form, full)
    assert got.shape[0] == 67 and bool(torch.isfinite(got.float()).all())
    head = _port_form(tool, form, [a[:64] for a in full])
    tail = _port_form(tool, form, [a[64:] for a in full])
    # the elementwise chains bitwise; the product within float32 summation
    # (a CPU matmul may block its sums by the row count)
    atol = 1e-6 * float(got.abs().max()) if tool == "mm" else 0.0
    torch.testing.assert_close(got[:64], head, rtol=0, atol=atol)
    torch.testing.assert_close(got[64:], tail, rtol=0, atol=atol)


@pytest.mark.parametrize("tool", ["mm", "silu", "repeat"])
def test_main_on_cpu_prints_the_three_forms(tool, capsys):
    mod = TOOLS[tool]
    mod.main(["--device", "cpu", "--iters", "1", "40"] + (["24"] if tool == "silu" else []))
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("cpu:")
    assert [ln.split(":")[0].strip() for ln in lines[1:]] == list(mod.FORMS)
    unit = {"mm": "us/matmul", "silu": "us/call", "repeat": "us/apply"}[tool]
    assert all(unit in ln and "err" in ln for ln in lines[1:])
    # the forms agree where the tool says they should: split and repeat/narrow exactly
    errs = [float(ln.rsplit("=", 1)[1]) for ln in lines[1:]]
    if tool == "mm":
        assert errs[2] <= 1e-6 and 0 < errs[1] < 1e-2
    elif tool == "repeat":
        assert errs == [0.0, 0.0, 0.0]


@pytest.mark.parametrize("tool", ["mm", "silu", "repeat"])
def test_main_without_a_card_raises(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TOOLS[tool].main([])


@pytest.mark.parametrize("tool", ["mm", "silu", "repeat"])
def test_wrappers_refuse_other_devices(tool):
    form = TOOLS[tool].FORMS[0]
    meta = [torch.empty(a.shape, dtype=torch.bfloat16, device="meta") for a in _inputs(tool, 2)]
    with pytest.raises(ValueError, match="unsupported device"):
        if tool == "mm":
            pf, pb = bench_mm.make_pool("meta")
            bench_mm.mm_chain_apply(meta[0], pf, pb, form)
        elif tool == "silu":
            bench_silu.silu_chain_apply(meta[0], form)
        else:
            bench_repeat.bcast_chain_apply(*meta, bench_repeat.qbcast("meta"), form)


def test_wrappers_refuse_bad_forms_and_shapes():
    x = torch.zeros(4, 2048, dtype=torch.bfloat16)
    pf, pb = bench_mm.make_pool()
    with pytest.raises(ValueError, match="form"):
        bench_mm.mm_chain_apply(x, pf, pb, "tf32")
    with pytest.raises(ValueError, match="pf / pb"):
        bench_mm.mm_chain_apply(x[:, :1024], pf, pb, "f32")
    with pytest.raises(ValueError, match="bf16"):
        bench_silu.silu_chain_apply(x.float(), "f32")
    with pytest.raises(ValueError, match="reps"):
        bench_silu.silu_chain_apply(x, "f32", reps=0)
    s = torch.zeros(4, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="v must be"):
        bench_repeat.bcast_chain_apply(s, x[:, :1024], bench_repeat.qbcast(), "narrow")


def test_timeit_on_the_cpu():
    calls = []
    t = timeit(lambda a: calls.append(a.sum()), torch.ones(3), iters=4)
    assert t > 0 and len(calls) == 5  # one warm-up
    with pytest.raises(ValueError, match="tensor"):
        timeit(lambda: None, iters=1)


# ---------------------------------------------------------------------------
# the exact bf16 splits behind mm_chain_kernel's f32 form on the tensor cores
# ---------------------------------------------------------------------------


def _magnitudes(shape, lo: int, hi: int, seed: int) -> torch.Tensor:
    """float32 values of random sign and mantissa at every power of two from
    2^lo to 2^hi."""
    rng = np.random.default_rng(seed)
    e = rng.integers(lo, hi + 1, size=shape)
    m = rng.uniform(1.0, 2.0, size=shape) * rng.choice([-1.0, 1.0], size=shape)
    return torch.from_numpy((m * np.exp2(e.astype(np.float64))).astype(np.float32))


SQUARES = {
    "normals": lambda: _torch_bf16(np.random.default_rng(7).standard_normal((R, jmm.K))),
    # x^2 from 2^-100 to 2^100
    "magnitudes": lambda: _magnitudes((R, 256), -50, 49, 8).to(torch.bfloat16),
}


@pytest.mark.parametrize("case", sorted(SQUARES))
def test_split_square_rebuilds_the_square_bitwise(case):
    x = SQUARES[case]()
    hi, lo = bench_mm.split_square(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    sq = x.float() * x.float()
    assert torch.equal(hi.float() + lo.float(), sq)


POOLS = {
    "normals": lambda: torch.randn((jmm.K, jmm.N), generator=torch.Generator().manual_seed(9)),
    "onehot": lambda: bench_mm.make_pool()[0],
    "magnitudes": lambda: _magnitudes((jmm.K, jmm.N), -100, 100, 10),
}


@pytest.mark.parametrize("case", sorted(POOLS))
def test_split_pool_rebuilds_the_pool_bitwise(case):
    pf = POOLS[case]()
    parts = bench_mm.split_pool(pf)
    assert parts.shape == (3, *pf.shape) and parts.dtype == torch.bfloat16
    p1, p2, p3 = parts.float()
    assert torch.equal((p1 + p2) + p3, pf)
    if case == "onehot":  # 1/128 is a bf16 value: the lower parts are zero
        assert not p2.any() and not p3.any()


@pytest.mark.parametrize("pool", ["onehot", "dense"])
def test_five_split_products_match_the_jax_f32_form(pool):
    """The f32 form as mm_chain_kernel computes it, hi*p1 + hi*p2 + hi*p3 +
    lo*p1 + lo*p2 (each product exact; lo*p3 dropped), summed in float64,
    against the JAX tool's f32 form (its make_kernel in interpret mode) at a
    ragged R = 1021, within chip_smoke.TOL_MM (1e-5) of max|ref|."""
    rows = 1021
    (x,) = _inputs("mm", rows, seed=11)
    pf = (bench_mm.make_pool()[0] if pool == "onehot"
          else torch.randn((jmm.K, jmm.N), generator=torch.Generator().manual_seed(12)))
    block = lambda a, b: pl.BlockSpec((a, b), lambda i: (0, 0))  # noqa: E731
    fn = pl.pallas_call(jmm.make_kernel("f32"), grid=(1,),
                        in_specs=[block(rows, jmm.K), block(jmm.K, jmm.N), block(jmm.K, jmm.N)],
                        out_specs=block(rows, jmm.N),
                        out_shape=jax.ShapeDtypeStruct((rows, jmm.N), jnp.float32),
                        interpret=True)
    want = np.asarray(fn(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pf.numpy()),
                         jnp.asarray(pf.numpy(), jnp.bfloat16)), np.float64)
    hi, lo = (t.double() for t in bench_mm.split_square(_torch_bf16(x)))
    p1, p2, p3 = bench_mm.split_pool(pf).double()
    got = bench_mm.REPS * (hi @ (p1 + p2 + p3) + lo @ (p1 + p2))  # bf16(0.999) = 1: equal reps
    top = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * top
