"""The EDM cell (``fpc-edm.batch``) on the CPU: the program built by
``pb.edm`` against the plain reference of EDM + DPM-Solver++(2M)
(``reference/samplers/dpmpp.py``) at a small size and the published
widths; a whole small run, sound and with the timed path broken
underneath (``correct`` must come out false, as in
``test_portbench_faults.py``); and the reader of the program's table
counter, with and without the counter."""

import dataclasses

import numpy as np
import pytest
import torch

import test_portbench_faults as faults

import graspldm_tpu_torch.models.cuda_sampler as cuda_sampler
import graspldm_tpu_torch.utils.profiling as profiling
from pb import edm, imports, program, spec, traffic, weights
from pb.harness import run_cell
from reference.generate import generate

CELL = "fpc-edm.batch"
CONFIG = "graspldm-fpc-z4-pc64-edm"


def config():
    return spec.load_json(spec.BENCH_DIR / "configs" / f"{CONFIG}.json")


def small_cell(name: str = CELL) -> spec.Cell:
    """The cell with 2 clouds, 8 grasps and 4 steps (``shrink.small_cell``
    shrinks the ``batch`` rig's mixes; this one names the ``edm`` rig)."""
    c = spec.cell(name)
    return dataclasses.replace(c, traffic=dict(c.traffic, clouds_per_call=2, grasps=8, steps=4))


@pytest.mark.parametrize("steps", [5, 32])
def test_reference_matches_the_programs_plain_path(steps):
    cfg = config()
    r_vae, r_ddm = weights.make(cfg, 123456789012, "cpu")
    prog = edm.build(cfg, {"vae": r_vae.state_dict(), "ddm": r_ddm.state_dict()}, "cpu", steps)
    B, G = 2, 8
    pc = torch.from_numpy(traffic.call_clouds(
        {"clouds": "full", "clouds_per_call": B, "points": 1024}, 7, 0))
    lat = cfg["sigma_max"] * torch.randn(B * G, cfg["grasp_latent_size"],
                                         generator=torch.Generator().manual_seed(0))
    got = program.generate(prog, pc, G, lat, steps, "dpmpp")
    want = generate(r_vae, r_ddm, cfg, pc, G, torch.arange(B * G), lat, steps,
                    spec.plugin("reference/samplers", "dpmpp"))
    for k in program.OUT_KEYS:
        g = got[k].reshape((B * G,) + tuple(got[k].shape[2:])).numpy()
        w = want[k].numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() < 1e-4, k
    assert np.abs(want["grasp_tmrp"].numpy()).max() > 1e-2  # not trivially zero


def test_the_reference_sampler_loads_neither_jax_nor_the_program():
    from test_portbench_imports import _loaded_after

    code = ("from pb import spec\nfrom reference import generate\n"
            "spec.plugin('reference/samplers', 'dpmpp')\n")
    assert imports.forbidden_loaded(_loaded_after(code), imports.FORBIDDEN_IN_REFERENCE) == []


def test_the_builder_refuses_other_edm_numbers():
    cfg = dict(config(), sigma_max=81.0)
    r_vae, r_ddm = weights.make(cfg, 5, "cpu")
    with pytest.raises(ValueError, match="sigma_max"):
        edm.build(cfg, {"vae": r_vae.state_dict(), "ddm": r_ddm.state_dict()}, "cpu", 5)


def test_row_numbers_are_the_mean_and_the_99th_percentile_of_a_rows_gap():
    rig = spec.plugin("rigs", "edm")
    R = 200
    want = {"grasp_tmrp": np.zeros((R, 6)), "grasps": np.zeros((R, 4, 4)),
            "confidence": np.zeros(R)}
    got = {k: v.copy() for k, v in want.items()}
    got["grasp_tmrp"][:3, 0] = 0.05  # three rows off by 1 cm: 1.0 in units of 0.05 m
    got["grasps"][0, 1, 2] = 2.0
    got["confidence"][:] = 1e-3  # every row
    n = rig.row_numbers(got, want)
    assert n["tmrp_mean_err"] == pytest.approx(3 / R) and n["tmrp_p99_err"] == pytest.approx(1.0)
    assert n["pose_mean_err"] == pytest.approx(2 / R) and n["pose_p99_err"] == 0.0
    assert n["conf_mean_err"] == pytest.approx(1e-3) and n["conf_p99_err"] == pytest.approx(1e-3)
    got["grasps"][5, 0, 0] = np.nan
    assert rig.row_numbers(got, want)["pose_mean_err"] == float("inf")


def _broken_tables(monkeypatch, edit):
    real = cuda_sampler.dpmpp_tables

    def tables(*a, **k):
        embin, trows, coefs = real(*a, **k)
        coefs = coefs.clone()
        edit(coefs)
        return embin, trows, coefs

    monkeypatch.setattr(cuda_sampler, "dpmpp_tables", tables)


def c_skip_dropped(monkeypatch):
    """The denoised estimate loses its skip term: ``D = c_out F``."""
    _broken_tables(monkeypatch, lambda c: c[:, 1].zero_())


def first_order_only(monkeypatch):
    """The 2M correction is skipped: every step uses ``D`` alone."""
    def edit(c):
        c[:, 3] = 1.0
        c[:, 4] = 0.0

    _broken_tables(monkeypatch, edit)


# the EDM sampler's own faults, and the harness's (test_portbench_faults.py)
FAULTS = {"c_skip_dropped": c_skip_dropped, "first_order_only": first_order_only,
          "state_unchanged": faults.state_unchanged, "half_batch": faults.half_batch,
          "answer_altered": faults.answer_altered}


def test_a_sound_run_is_correct():
    out = run_cell(CELL, 21, 1.0, False, device="cpu", cell=small_cell(CELL))
    assert out.result["correct"], (out.faults, out.checks)
    assert set(out.result["metrics"]) == {"grasps_per_s", "setup_s"}


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_run_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = run_cell(CELL, 22, 1.0, False, device="cpu", cell=small_cell(CELL))
    assert not out.result["correct"]
    assert any(not c["ok"] for c in out.checks), out.faults  # caught by the comparison
    assert not any("call" in f for f in out.faults), out.faults


def _host_layer_run(cell):
    """A traced run reading only the cell's host-clock per-layer metrics."""
    cell = dataclasses.replace(cell, per_layer=[m for m in cell.per_layer
                                                if m["source"] == "host_clock"])
    return run_cell(CELL, 23, 0.5, True, device="cpu", cell=cell)


def test_the_tables_counter_is_read_a_call():
    out = _host_layer_run(small_cell(CELL))
    assert out.result["correct"], (out.faults, out.checks)
    assert out.result["metrics"]["sampler_tables_ms_per_call"]["value"] > 0


def test_without_the_counter_its_metric_is_left_out(monkeypatch):
    """A program without ``SAMPLER_TABLES`` (the parent's) runs the cell,
    and the metric is missing from the line, not an error."""
    monkeypatch.delattr(profiling, "SAMPLER_TABLES")
    monkeypatch.setattr(cuda_sampler, "SAMPLER_TABLES",
                        profiling.HostTime("sampler_tables"))  # the sampler still runs
    out = _host_layer_run(small_cell(CELL))
    assert out.result["correct"], (out.faults, out.checks)
    assert "sampler_tables_ms_per_call" not in out.result["metrics"]
    assert "mfu_pct" in out.result["metrics"]
