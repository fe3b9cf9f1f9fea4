"""The lower-precision control on the card, at each cell's own size: the
same program with its denoiser and decoder in bfloat16 must come out not
correct against the limits, and the program as the configuration states
it (float32) correct, on a short window at the cell's own load. The
benchmark's own runs do not run the control; ``portbench/tools/
calibrate.py`` reads it over several seeds.

    python -m pytest -p no:cacheprovider portbench/tests/test_portbench_control.py -m cuda
"""

import pytest

from pb import spec
from pb.harness import run_cell

CELLS = ("fpc.batch", "ppc.serve", "ppc.batch", "fpc.vae")
SECONDS = {"fpc.batch": 1.0, "ppc.batch": 1.0, "fpc.vae": 1.0, "ppc.serve": 3.0}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_bf16_control_is_not_correct(cell, cuda_device):
    c = spec.cell(cell, pending=True)
    out = run_cell(cell, 5_000_000_017, SECONDS[cell], False, device=cuda_device, control=True,
                   cell=c)
    assert not out.result["correct"]
    assert any(not x["ok"] for x in out.checks)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_float32_program_is_correct(cell, cuda_device):
    out = run_cell(cell, 5_000_000_029, SECONDS[cell], False, device=cuda_device,
                   cell=spec.cell(cell, pending=True))
    assert out.result["correct"], (out.faults, out.checks)
