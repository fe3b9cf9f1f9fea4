"""The program's spans read against the device's operations (``pb.spans``),
on hand-built intervals, on stand-ins for profiler events, and on a shrunk
cell's windows on the CPU (``portbench/tools/spans.py``)."""

import types

import pytest
import torch
from shrink import small_cell
from torch.autograd import DeviceType

from pb import spans, spec

# two calls of 100 us each; inside each, encode [10, 40], decode [61, 95]
HOST = [
    (0.0, 100.0, "portbench.generate"), (200.0, 300.0, "portbench.generate"),
    (5.0, 98.0, "graspldm.vae_generate"), (205.0, 298.0, "graspldm.vae_generate"),
    (10.0, 40.0, "graspldm.encode"), (210.0, 240.0, "graspldm.encode"),
    (61.0, 95.0, "graspldm.decode"), (261.0, 295.0, "graspldm.decode"),
    (12.0, 20.0, "aten::cudnn_convolution"), (61.0, 63.0, "cudaLaunchKernel"),
]
# (start, end, name, launched): a conv launched at 12 runs 20-30, a norm
# launched at 30 runs 30-50 (past encode's end: its busy time still counts
# for encode), the decoder launched at 61 runs 70-90, a copy back launched
# outside every program span runs 99-110; the second call alike
DEVICE = [
    (20.0, 30.0, "conv", 12.0), (30.0, 50.0, "norm", 30.0), (70.0, 90.0, "stage_kernel", 61.0),
    (99.0, 110.0, "memcpy", 99.0),
    (220.0, 230.0, "conv", 212.0), (230.0, 250.0, "norm", 230.0),
    (270.0, 290.0, "stage_kernel", 261.0), (299.0, 310.0, "memcpy", 299.0),
]


def test_device_time_is_read_by_the_span_that_launched_it():
    r = spans.read(DEVICE, HOST)
    assert r.calls == {"graspldm.vae_generate": 2, "graspldm.encode": 2, "graspldm.decode": 2}
    assert r.device_s["graspldm.encode"] == pytest.approx(2 * 30e-6)  # 20-50, twice
    assert r.device_s["graspldm.decode"] == pytest.approx(2 * 20e-6)
    assert r.device_s["graspldm.vae_generate"] == pytest.approx(2 * 50e-6)
    assert r.unlinked_s == 0.0
    encode_ms_per_call = 1e3 * r.device_s["graspldm.encode"] / 2
    assert encode_ms_per_call == pytest.approx(0.030)


def test_program_idle_is_the_gaps_inside_the_program_spans():
    # gaps: 50-70 (inside), 90-99 (straddles vae_generate's end at 98: 8 us
    # inside), 110-220 (98 < 110, 205-220 inside: 15 us), 250-270, 290-299
    # (290-298: 8 us), no gap after the last operation
    r = spans.read(DEVICE, HOST)
    inside = 20 + 8 + 15 + 20 + 8
    assert r.program_idle_s == pytest.approx(inside * 1e-6)
    assert 1e3 * r.program_idle_s / 2 == pytest.approx(inside / 2 * 1e-3)
    total_idle = sum(v for _, v in r.idle)
    assert total_idle == pytest.approx((20 + 9 + 110 + 20 + 9) * 1e-6)
    assert r.program_idle_s <= total_idle


def test_span_copies_on_the_device_timeline_change_nothing():
    copies = [(20.0, 90.0, "graspldm.vae_generate", None), (20.0, 50.0, "graspldm.encode", None),
              (20.0, 110.0, "portbench.generate", None)]
    plain, with_copies = spans.read(DEVICE, HOST), spans.read(DEVICE + copies, HOST)
    assert with_copies == plain


def test_a_gap_is_labelled_by_harness_span_program_span_and_operation():
    host = HOST + [(52.0, 68.0, "aten::empty")]  # in the first call only
    idle = dict(spans.read(DEVICE, host).idle)
    assert idle == pytest.approx({
        "portbench.generate / graspldm.vae_generate / aten::empty": 20e-6,  # 50-70
        "portbench.generate / graspldm.vae_generate": 20e-6,  # 250-270
        "portbench.generate / graspldm.decode": 18e-6,  # 90-99 and 290-299
        "no host operation": 110e-6,  # 110-220
    })


def _event(name, device_type, id_, start, end):
    return types.SimpleNamespace(name=name, device_type=device_type, id=id_,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def test_launches_follow_the_profilers_correlation():
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [
        _event("aten::mm", cpu, 7, 10.0, 20.0),  # an operator: ids of another sequence
        _event("cudaLaunchKernel", cpu, 900, 12.0, 13.0),
        _event("cudaMemcpyAsync", cpu, 901, 21.0, 22.0),
        _event("gemm", cuda, 900, 30.0, 40.0),
        _event("Memcpy DtoH", cuda, 901, 40.0, 50.0),
        _event("memset", cuda, 7, 50.0, 51.0),  # no runtime call 7
    ]
    device, host = spans.from_events(events)
    assert device == [(30.0, 40.0, "gemm", 12.0), (40.0, 50.0, "Memcpy DtoH", 21.0),
                      (50.0, 51.0, "memset", None)]
    assert host == [(10.0, 20.0, "aten::mm"), (12.0, 13.0, "cudaLaunchKernel"),
                    (21.0, 22.0, "cudaMemcpyAsync")]


@pytest.mark.parametrize("name, entry", [("fpc.vae", "vae_generate"),
                                         ("ppc.batch", "ldm_generate")])
def test_a_shrunk_cell_records_one_entry_span_a_call(name, entry):
    measure = spec.plugin("tools", "spans").measure
    out = measure(small_cell(name), 11, 0.5, torch.device("cpu"))
    n = out["calls"] + out["failed"]
    assert n >= 1 and out["failed"] == 0
    assert out["span_calls"][spans.PROGRAM + entry] == n
    assert out["span_calls"][spans.PROGRAM + "encode"] == n
    assert out["span_calls"][spans.PROGRAM + "decode"] == n
    assert out["span_copies_on_device"] == 0
    assert out["program_idle_ms_per_call"] == 0.0  # no device timeline on the CPU
    assert out["idle_ms_per_call_by_span"] == {}
