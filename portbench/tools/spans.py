#!/usr/bin/env python3
"""Where a cell's call spends its device time and its device idle, by the
program's own spans (``pb.spans``). On the card, from the repository root:

    python3 portbench/tools/spans.py --workload fpc.vae --seed 7 --seconds 10

Sets the cell up as ``run.py`` does, measures one window untraced and one
under ``torch.profiler`` (both after a warm-up call), and prints one JSON
line: the calls' median seconds in each window (what tracing costs the
host), the traced window's busy share and idle a call, ``torch_ops`` a call
(the benchmark's reader), and from the spans the device time a call of the
operations launched in each span, the device idle a call inside the
program's spans, the idle a call by innermost program span, and the idle by
label (harness span / program span / host operation), largest first.
``span_copies_on_device`` counts events of the program's spans on the
device timeline (0: they add nothing to device time).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]

from pb import spans, spec  # noqa: E402
from pb.harness import PROGRAM_CSRC, Run, set_float32  # noqa: E402
from pb.trace import Tracer, handwritten_kernels  # noqa: E402

TOP = 12


def _median_call_s(win: dict) -> float:
    return statistics.median(c["end"] - c["start"] for c in win["calls"])


def measure(cell: spec.Cell, seed: int, seconds: float, device) -> dict:
    """The cell's untraced and traced windows, read as the module says."""
    import torch

    set_float32()
    tracer = Tracer(False, cuda=device.type == "cuda")
    rig = spec.plugin("rigs", cell.traffic["rig"], cell.root).Rig(cell, seed, seconds, device,
                                                                  tracer)
    try:
        rig.warm(seconds)
        plain = rig.window(seconds)
        rig.warm(seconds)
        tracer.enabled = True
        traced = rig.window(seconds)
    finally:
        rig.free_program()
    summary = tracer.summary(traced["window_s"])
    events = tracer.prof.events()
    reading = spans.read(*spans.from_events(events))
    calls = sum(c["error"] is None for c in traced["calls"])
    run = Run(cell, 0.0, traced["window_s"], traced["calls"], None, None, summary,
              handwritten_kernels(PROGRAM_CSRC))
    torch_ops = spec.metric_reader("torch_ops_ms_per_call", cell.root)(run)
    per_call = {n: 1e3 * s / calls for n, s in sorted(reading.device_s.items())}
    by_span = collections.defaultdict(float)
    for label, s in reading.idle:
        inner = [p for p in label.split(" / ") if p.startswith(spans.PROGRAM)]
        by_span[inner[0] if inner else "outside the program"] += 1e3 * s / calls
    return {
        "workload": cell.name, "seed": seed,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "calls": calls, "failed": len(traced["calls"]) - calls,
        "median_call_s": {"untraced": _median_call_s(plain), "traced": _median_call_s(traced)},
        "busy_share": summary.busy_s / summary.window_s,
        "idle_ms_per_call": 1e3 * (summary.window_s - summary.busy_s) / calls,
        "torch_ops_ms_per_call": torch_ops,
        "span_calls": reading.calls,
        "device_ms_per_call": per_call,
        "encode_ms_per_call": per_call.get(spans.PROGRAM + "encode"),
        "program_idle_ms_per_call": 1e3 * reading.program_idle_s / calls,
        "idle_ms_per_call_by_span": dict(by_span),
        "unlinked_ms_per_call": 1e3 * reading.unlinked_s / calls,
        "span_copies_on_device": sum(
            1 for e in events if e.device_type.name == "CUDA" and e.name.startswith(spans.PROGRAM)),
        "idle_ms_per_call_by_label": [[k, 1e3 * v / calls] for k, v in reading.idle[:TOP]],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from graspldm_tpu_torch.utils.profiling import device_line

    out = measure(spec.cell(a.workload), a.seed, a.seconds, torch.device("cuda"))
    out["card"] = device_line(torch.device("cuda"))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
