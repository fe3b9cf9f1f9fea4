"""A whole run on the CPU (the look for a card skipped) with the timed path
broken underneath: ``correct`` must come out false, for each fault that a
cell can have. The cells run on one chip, so there is no exchange between
chips to leave out."""

import pytest
import torch
from shrink import small_cell

import graspldm_tpu_torch.inference.pipeline as pipeline
from pb.harness import run_cell

CELLS = ("fpc.batch", "ppc.batch", "fpc.vae", "ppc.serve")
LDM_CELLS = ("fpc.batch", "ppc.batch", "ppc.serve")


def state_unchanged(monkeypatch):
    """The sampler returns its state as it got it."""
    monkeypatch.setattr(pipeline, "_fused_sample", lambda w, d, emb, x_T, *a, **k: x_T[:, None, :])


def half_batch(monkeypatch):
    """The decoder computes the first half of the rows; the rest get their mean."""
    real = pipeline.decoder_fast_apply

    def decode(w, z_h, z_pc, *a, **k):
        h = max(1, z_h.shape[0] // 2)
        out = real(w, z_h[:h], z_pc[:h], *a, **k)
        return tuple(torch.cat([o, o.mean(0, keepdim=True).expand(z_h.shape[0] - h, -1)])
                     for o in out)

    monkeypatch.setattr(pipeline, "decoder_fast_apply", decode)


def answer_altered(monkeypatch):
    """Each cloud's first grasp moves 1 cm where it is produced."""
    real = pipeline.decode_and_postprocess

    def post(*a, **k):
        out = real(*a, **k)
        out["grasp_tmrp"][:, 0, 0] += 0.01
        return out

    monkeypatch.setattr(pipeline, "decode_and_postprocess", post)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}
CASES = [(c, f) for c in CELLS for f in FAULTS if f != "state_unchanged" or c in LDM_CELLS]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = run_cell(cell, 21, 1.0, False, device="cpu", cell=small_cell(cell))
    assert out.result["correct"], (out.faults, out.checks)


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_run_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = run_cell(cell, 22, 1.0, False, device="cpu", cell=small_cell(cell))
    assert not out.result["correct"]
    assert any(not c["ok"] for c in out.checks), out.faults  # caught by the comparison
    assert not any("call" in f or "HTTP" in f for f in out.faults), out.faults
