"""One run of one cell: set-up, warm-up, the measured (or traced) window,
the check against the reference, and the result line's contents."""

from __future__ import annotations

import dataclasses
import gc
import math
import os
import time
from typing import List, Optional

import torch

from . import spec
from .compare import verdict
from .trace import TraceSummary, Tracer, handwritten_kernels

T_IMPORT = time.perf_counter()
PROGRAM_CSRC = spec.ROOT / "graspldm_tpu_torch" / "csrc"


def process_age_s() -> float:
    """Seconds since this process started (``/proc``; else since this
    module was imported)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


@dataclasses.dataclass
class Run:
    """What the metric readers read (``portbench/metrics/<name>.py``)."""

    cell: spec.Cell
    setup_s: float
    window_s: float
    calls: List[dict]  # batch: the window's calls; serve: the batch callable's calls
    requests: Optional[List[dict]]  # serve: the window's requests
    batcher: Optional[dict]  # serve: the batcher's counters over the window
    trace: Optional[TraceSummary]
    handwritten: set

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def sampler(self):
        """The reference sampler that the mix names (``evaluations(steps)``)."""
        return spec.plugin("reference/samplers", self.traffic["sampler"], self.cell.root)


@dataclasses.dataclass
class Outcome:
    result: dict
    checks: List[dict]
    faults: List[str]
    notes: List[str]  # how the run went, for standard error


def set_float32() -> None:
    """The configurations state float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class GcWatch:
    """The interpreter's garbage collections while enabled: count and
    seconds by generation (a full collection stops every thread)."""

    def __init__(self):
        self.on, self.t0 = False, 0.0
        self.n, self.s = [0, 0, 0], [0.0, 0.0, 0.0]
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self.t0 = time.perf_counter()
        elif self.on:
            self.n[info["generation"]] += 1
            self.s[info["generation"]] += time.perf_counter() - self.t0

    def close(self) -> str:
        gc.callbacks.remove(self._cb)
        return ", ".join(f"gen{g} {self.n[g]} in {self.s[g]:.3f} s" for g in range(3))


def describe(label: str, win: dict) -> str:
    durations = sorted(c["end"] - c["start"] for c in win["calls"])
    return (f"{label} {win['window_s']:.3f} s, {len(durations)} calls"
            + (f" (median {durations[len(durations) // 2]:.4f} s, longest {durations[-1]:.4f} s)"
               if durations else ""))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None,
             control: bool = False, cell: Optional[spec.Cell] = None) -> Outcome:
    """Run cell ``name`` once. ``device`` defaults to the card; ``cell``
    overrides what ``BENCHMARK.json`` gives (tests shrink it).

    Every run measures one window untraced: the end-to-end metrics, and
    the per-layer metrics read by the host's clock or from the program's
    counters, come from it, and so does the check. With ``trace`` a second
    window follows under ``torch.profiler``, for the per-layer metrics read
    from the device trace (the profiler slows the host)."""
    set_float32()
    cell = cell or spec.cell(name)
    device = torch.device(device or "cuda")
    tracer = Tracer(False, cuda=device.type == "cuda")
    mix = cell.traffic
    phases = {"start": process_age_s()}
    if device.type == "cuda":
        torch.zeros((), device=device)  # the CUDA context
        phases["cuda"] = process_age_s() - phases["start"]
    rig = spec.plugin("rigs", mix["rig"], cell.root).Rig(cell, seed, seconds, device, tracer,
                                                         control)
    phases.update(rig.phases)
    watch, traced = GcWatch(), None
    try:
        t = time.perf_counter()
        rig.warm(seconds)
        if device.type == "cuda":
            torch.cuda.synchronize()
        phases["warm"] = time.perf_counter() - t
        setup_s = process_age_s()
        watch.on = True
        win = rig.window(seconds)
        watch.on = False
        if trace:
            rig.warm(seconds)
            tracer.enabled = True
            traced = rig.window(seconds)
        memory_peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    finally:
        gc_note = watch.close()
        rig.free_program()
    summary = tracer.summary(traced["window_s"]) if trace else None
    t_check = time.perf_counter()
    values, faults = rig.check(win)
    check_s = time.perf_counter() - t_check
    checks = verdict(values, cell.limits)
    handwritten = handwritten_kernels(PROGRAM_CSRC)

    def run_of(w, s):
        return Run(cell, setup_s, w["window_s"], w["calls"], w.get("requests"),
                   w.get("batcher"), s, handwritten)

    host_run = run_of(win, None)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        run = run_of(traced, summary) if m["source"] == "device_trace" else host_run
        v = spec.metric_reader(m["name"], cell.root)(run)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    attempted, failed = rig.tally(win)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": memory_peak}
    result = {"correct": not faults and bool(checks) and all(c["ok"] for c in checks),
              "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"], dev["window_s"] = summary.busy_s, summary.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in summary.device_ops],
                               "idle_gaps": [list(x) for x in summary.idle_gaps]}
    # each compared number beside its limit, under a key of its own, last
    result["checks"] = {c["name"]: {"value": c["value"] if math.isfinite(c["value"]) else None,
                                    "limit": c["limit"]} for c in checks}
    notes = [f"setup {setup_s:.3f} s; " + describe("window", win)
             + (f"; traced {describe('window', traced)}" if traced else "")
             + f"; reference check {check_s:.3f} s",
             "setup parts " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()),
             f"garbage collections in the window: {gc_note}"]
    return Outcome(result, checks, faults, notes)
