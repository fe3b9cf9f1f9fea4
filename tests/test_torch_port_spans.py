"""The generation pipeline's profiler spans (``utils/profiling.py:span``).

Without a recording profiler a call opens no range at all; under
``torch.profiler.profile`` each call records its entry's span with
``encode``, ``sample`` (LDM) and ``decode`` nested inside, once a call, and
one ``decode`` per decoded state of a trajectory; ``sampler_tables`` nests
inside ``sample``, and ``SAMPLER_TABLES`` counts one table build a call for
every sampler, with or without a profiler. The spans are host ranges, not
user annotations, so the CUDA profiler puts no copy of them on the device's
timeline.

A tiny flagship on the CPU (64-point clouds, PVCNN channels x 0.125, voxel
grids x 0.25, ``block_channels`` (16, 32), B = 2 clouds x G = 4 grasps, 5
DDIM steps), its weights drawn from a fixed generator; the EDM samplers on
the same model with ``elucidated=True``.
"""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from graspldm_tpu_torch.flagship import FlagshipConfig, build_flagship
from graspldm_tpu_torch.inference import ldm_generate, vae_generate
from graspldm_tpu_torch.inference.pipeline import trajectory_decode_indices
from graspldm_tpu_torch.utils.profiling import SAMPLER_TABLES, SPAN_PREFIX

CFG = FlagshipConfig(pc_num_points=64, pc_scale_channels=0.125, pc_scale_voxel_resolution=0.25,
                     block_channels=(16, 32), dropout=None)
B, G, STEPS = 2, 4, 5


@pytest.fixture(scope="module")
def models():
    return build_flagship(CFG, generator=torch.Generator().manual_seed(0), device="cpu")


@pytest.fixture(scope="module")
def edm_models():
    return build_flagship(dataclasses.replace(CFG, elucidated=True),
                          generator=torch.Generator().manual_seed(0), device="cpu")


def _call(models, entry: str, sampler: str = "ddim"):
    vae, ddm, diffusion = models
    pc = torch.randn((B, CFG.pc_num_points, 3), generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    if entry == "vae":
        return vae_generate(vae, pc, G, generator=gen)
    return ldm_generate(vae, ddm, diffusion, pc, G, generator=gen, num_inference_steps=STEPS,
                        sampler=sampler, return_trajectory=entry == "trajectory")


def _refuse(*args, **kwargs):
    raise AssertionError("a profiler range was opened with no profiler recording")


@pytest.mark.parametrize("entry", ["ldm", "vae"])
def test_no_range_is_opened_without_a_profiler(models, entry, monkeypatch):
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _refuse)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    out = _call(models, entry)
    assert out["grasps"].shape == (B, G, 4, 4)


def _ancestors(e):
    names, p = [], e.cpu_parent
    while p is not None:
        names.append(p.name)
        p = p.cpu_parent
    return names


@pytest.mark.parametrize("entry, outer, counts", [
    ("ldm", "ldm_generate", {"encode": 1, "sample": 1, "sampler_tables": 1, "decode": 1}),
    ("vae", "vae_generate", {"encode": 1, "decode": 1}),
    ("trajectory", "ldm_generate",
     {"encode": 1, "sample": 1, "sampler_tables": 1,
      "decode": 1 + len(trajectory_decode_indices(STEPS + 1))}),
])
def test_spans_nest_under_the_entry_once_a_call(models, entry, outer, counts):
    _call(models, entry)  # the first call's one-off work stays out of the profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _call(models, entry)
    spans = [e for e in prof.events() if e.name.startswith(SPAN_PREFIX)]
    top = [e for e in spans if e.name == SPAN_PREFIX + outer]
    assert len(top) == 1
    seen = {}
    for e in spans:
        assert not e.is_user_annotation, e.name
        if e is top[0]:
            continue
        name = e.name[len(SPAN_PREFIX):]
        seen[name] = seen.get(name, 0) + 1
        assert _ancestors(e)[-1] == top[0].name, (e.name, _ancestors(e))
        assert top[0].time_range.start <= e.time_range.start <= e.time_range.end \
            <= top[0].time_range.end
    assert seen == counts
    # the layers run one after another: encode, then sample (its tables
    # first), then decode
    first = {n: min(e.time_range.start for e in spans if e.name == SPAN_PREFIX + n)
             for n in counts}
    assert sorted(counts, key=first.get) == [
        n for n in ("encode", "sample", "sampler_tables", "decode") if n in counts]


@pytest.mark.parametrize("sampler", ["ddim", "dpmpp", "churn"])
def test_each_sampler_times_its_tables_once_a_call(models, edm_models, sampler):
    """``graspldm.sampler_tables`` sits right inside ``graspldm.sample``;
    ``SAMPLER_TABLES`` counts a build a call whether a profiler records or
    not, and its seconds cover the span."""
    m = models if sampler == "ddim" else edm_models
    calls, seconds = SAMPLER_TABLES.calls, SAMPLER_TABLES.seconds
    _call(m, "ldm", sampler)
    assert SAMPLER_TABLES.calls == calls + 1 and SAMPLER_TABLES.seconds > seconds
    seconds = SAMPLER_TABLES.seconds
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _call(m, "ldm", sampler)
    assert SAMPLER_TABLES.calls == calls + 2
    tables = [e for e in prof.events() if e.name == SPAN_PREFIX + "sampler_tables"]
    assert len(tables) == 1
    assert tables[0].cpu_parent.name == SPAN_PREFIX + "sample"
    span_s = (tables[0].time_range.end - tables[0].time_range.start) / 1e6
    assert SAMPLER_TABLES.seconds - seconds >= span_s - 2e-6 and span_s > 0  # us clock


def test_the_profiler_gate_is_there():
    """``span`` asks ``torch.autograd._profiler_enabled`` (about 0.1 us) and
    opens ``torch._C._profiler._RecordFunctionFast``: both private, so a
    torch without them fails here and not in a traced run."""
    assert torch.autograd._profiler_enabled() is False
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch.autograd._profiler_enabled() is True
        with torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + "probe"):
            torch.ones(2).sum()
    assert torch.autograd._profiler_enabled() is False
    probe = [e for e in prof.events() if e.name == SPAN_PREFIX + "probe"]
    assert len(probe) == 1 and not probe[0].is_user_annotation
