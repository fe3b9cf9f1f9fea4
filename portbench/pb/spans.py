"""The program's own spans in a traced window: the host ranges named
``graspldm.*`` that ``graspldm_tpu_torch.utils.profiling.span`` opens at
its layer boundaries (``ldm_generate`` / ``vae_generate``, with
``encode``, ``sample`` and ``decode`` inside), read against the device's
operations on the profiler's one clock.

* ``calls``: ranges by span name;
* ``device_s``: by span name, the device busy seconds (the union of the
  operations' intervals) of the operations launched from inside its
  ranges. An operation is tied to the runtime call that launched it by
  the profiler's correlation id (:func:`from_events`), kernels launched
  through ``ctypes`` included;
* ``program_idle_s``: the device-idle seconds (the gaps between the
  device's operations) that fall inside a program span, an exact interval
  intersection over every gap;
* ``idle``: every gap labelled by what the host was in at its middle: the
  harness's span (``portbench.*``), the innermost program span and the
  innermost host operation.

A program without the spans reads ``calls`` empty. ``run.py``'s metrics do
not read this module: ``pb.trace.Tracer.summary`` reduces the trace before
a reader sees it, so a metric of the spans needs ``pb/trace.py`` to call
:func:`read` (PERF.md §7). ``portbench/tools/spans.py`` prints it for a
cell's traced window.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

from .trace import NAME_CHARS
from .trace import SPAN_PREFIX as HARNESS

PROGRAM = "graspldm."
LOOKBACK = 256  # host operations searched back from a gap's middle, as pb.trace does


@dataclasses.dataclass
class SpanReading:
    calls: Dict[str, int]
    device_s: Dict[str, float]
    program_idle_s: float
    idle: List[Tuple[str, float]]  # idle seconds by label, largest first
    unlinked_s: float  # device seconds with no launching host event found


def merge(intervals) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(a, b) -> float:
    """The length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


class _Cover:
    """Which merged interval of one name holds a time: ``start_at(t)`` is
    the start of the interval around ``t``, or None."""

    def __init__(self, merged):
        self.merged = merged
        self.starts = [s for s, _ in merged]

    def start_at(self, t: float) -> Optional[float]:
        k = bisect.bisect_right(self.starts, t) - 1
        return self.merged[k][0] if k >= 0 and self.merged[k][1] >= t else None


def _innermost(covers: Dict[str, _Cover], t: float) -> Optional[str]:
    """The name whose interval around ``t`` started last (the innermost of
    nested spans)."""
    best, best_start = None, None
    for name, c in covers.items():
        s = c.start_at(t)
        if s is not None and (best_start is None or s > best_start):
            best, best_start = name, s
    return best


def read(device: list, host: list) -> SpanReading:
    """``device``: ``(start_us, end_us, name, launched_us)``, ``launched_us``
    the start of the host event that launched it (None if not found);
    ``host``: ``(start_us, end_us, name)``. Span copies on the device
    timeline (names with either prefix) are not device operations."""
    device = [d for d in device if not d[2].startswith((PROGRAM, HARNESS))]
    by_name: Dict[str, list] = collections.defaultdict(list)
    ops = []
    for s, e, name in host:
        if name.startswith((PROGRAM, HARNESS)):
            by_name[name].append((s, e))
        else:
            ops.append((s, e, name))
    covers = {n: _Cover(merge(iv)) for n, iv in by_name.items()}
    program = {n: c for n, c in covers.items() if n.startswith(PROGRAM)}
    harness = {n: c for n, c in covers.items() if n.startswith(HARNESS)}

    launched: Dict[str, list] = collections.defaultdict(list)
    unlinked = 0.0
    for s, e, _, t in device:
        if t is None:
            unlinked += e - s
            continue
        for n, c in program.items():
            if c.start_at(t) is not None:
                launched[n].append((s, e))

    busy = merge((s, e) for s, e, _, _ in device)
    gaps = [(busy[k][1], busy[k + 1][0]) for k in range(len(busy) - 1)]
    in_program = merge(iv for n, c in program.items() for iv in c.merged)

    ops.sort()
    op_starts = [o[0] for o in ops]
    idle: Dict[str, float] = collections.defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        op = None
        k = bisect.bisect_right(op_starts, mid) - 1
        for k in range(k, max(-1, k - LOOKBACK), -1):
            if ops[k][1] >= mid:
                op = ops[k][2]
                break
        parts = [_innermost(harness, mid), _innermost(program, mid), op]
        label = " / ".join(p[:NAME_CHARS // 2] for p in parts if p) or "no host operation"
        idle[label] += (b - a) / 1e6
    return SpanReading(
        calls={n: len(iv) for n, iv in by_name.items() if n.startswith(PROGRAM)},
        device_s={n: sum(e - s for s, e in merge(iv)) / 1e6 for n, iv in launched.items()},
        program_idle_s=overlap(gaps, in_program) / 1e6,
        idle=sorted(idle.items(), key=lambda kv: -kv[1]),
        unlinked_s=unlinked / 1e6,
    )


def from_events(events) -> Tuple[list, list]:
    """``(device, host)`` for :func:`read` from ``torch.profiler``'s
    ``prof.events()``. A device event carries the correlation id of the
    runtime call that launched it (``cudaLaunchKernel``, ``cudaMemcpyAsync``,
    ...) as its ``id``, and that host event carries the same ``id``: the
    launch time is that call's start. Only host events named ``cu*`` are
    runtime calls; an operator's ``id`` counts in another sequence."""
    from torch.autograd import DeviceType

    device, host, calls = [], [], {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            device.append(e)
            continue
        host.append((e.time_range.start, e.time_range.end, e.name))
        if e.name.startswith("cu"):
            calls[e.id] = e.time_range.start
    return [(e.time_range.start, e.time_range.end, e.name, calls.get(e.id))
            for e in device], host
