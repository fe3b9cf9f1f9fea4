"""The traced window: ``torch.profiler`` over the window, reduced to what
the per-layer metrics read.

* device time and launches by kernel, by the kernel's base name (``void
  ddim_sampler_kernel<float>(...)`` -> ``ddim_sampler_kernel``);
* ``busy_s``: the union of the device's operation intervals (kernels,
  copies, sets) in the window;
* idle gaps between them, each labelled by what the host was doing at its
  middle: the harness's own span (``portbench.*``) and the innermost host
  operation then running.

The harness's spans are ``torch.profiler.record_function`` ranges; with
tracing off they cost nothing (:meth:`Tracer.span` is a null context).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Tuple

SPAN_PREFIX = "portbench."
TOP = 10
LABELLED_GAPS = 500
NAME_CHARS = 200  # of a name in the breakdown


def base_name(kernel: str) -> str:
    """``void (anonymous namespace)::name<T>(args)`` -> ``name``, ``void
    ns::name<T>(args)`` -> ``ns::name``; other names unchanged."""
    s = kernel.strip().replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    cut = [i for i in (s.find("<"), s.find("(")) if i >= 0]
    return (s[:min(cut)] if cut else s).strip()


def handwritten_kernels(csrc: Path) -> set:
    """Names of the ``__global__`` functions in the program's CUDA sources."""
    names = set()
    for path in sorted(csrc.glob("*.cu*")):
        text = path.read_text()
        for m in re.finditer(r"__global__", text):
            head = text[m.end():text.find("{", m.end())]
            head = _drop_parens_after(head, "__launch_bounds__")
            ident = re.search(r"(\w+)\s*\(", head)
            if ident:
                names.add(ident.group(1))
    return names


def _drop_parens_after(s: str, word: str) -> str:
    i = s.find(word)
    if i < 0:
        return s
    j, depth = s.index("(", i), 0
    for k in range(j, len(s)):
        depth += {"(": 1, ")": -1}.get(s[k], 0)
        if depth == 0:
            return s[:i] + s[k + 1:]
    return s


@dataclasses.dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    kernel_s: Dict[str, float]  # by base name
    launches: Dict[str, int]
    device_ops: List[Tuple[str, float]]  # largest first, full names
    idle_gaps: List[Tuple[str, float]]  # idle seconds by host activity, largest first


class Tracer:
    """``with tracer.window():`` profiles the window when enabled."""

    def __init__(self, enabled: bool, cuda: bool = True):
        self.enabled, self.cuda = enabled, cuda
        self.prof = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(SPAN_PREFIX + name)

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        with profile(activities=acts) as prof:
            yield
            if self.cuda:
                torch.cuda.synchronize()
        self.prof = prof

    def summary(self, window_s: float) -> TraceSummary:
        from torch.autograd import DeviceType

        device, host = [], []
        for e in self.prof.events():
            iv = (e.time_range.start, e.time_range.end, e.name)
            if e.device_type != DeviceType.CUDA:
                host.append(iv)
            elif not e.name.startswith(SPAN_PREFIX):  # a span's copy on the device timeline
                device.append(iv)
        return summarize(device, host, window_s)


def summarize(device: list, host: list, window_s: float) -> TraceSummary:
    """``device`` and ``host``: ``(start_us, end_us, name)`` intervals."""
    kernel_s: Dict[str, float] = collections.defaultdict(float)
    launches: Dict[str, int] = collections.defaultdict(int)
    by_full: Dict[str, float] = collections.defaultdict(float)
    for s, e, name in device:
        kernel_s[base_name(name)] += (e - s) / 1e6
        launches[base_name(name)] += 1
        by_full[name] += (e - s) / 1e6
    busy, gaps, cur = 0.0, [], None
    for s, e, _ in sorted(device):
        if cur is None:
            cur = [s, e]
        elif s > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    return TraceSummary(
        busy_s=busy / 1e6, window_s=window_s, kernel_s=dict(kernel_s), launches=dict(launches),
        device_ops=[(n[:NAME_CHARS], t)
                    for n, t in sorted(by_full.items(), key=lambda kv: -kv[1])[:TOP]],
        idle_gaps=_label_gaps(gaps, host),
    )


def _label_gaps(gaps: list, host: list) -> List[Tuple[str, float]]:
    spans = [h for h in host if h[2].startswith(SPAN_PREFIX)]
    ops = sorted(h for h in host if not h[2].startswith(SPAN_PREFIX))
    starts = [h[0] for h in ops]
    idle: Dict[str, float] = collections.defaultdict(float)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    for a, b in gaps[:LABELLED_GAPS]:
        mid = (a + b) / 2
        span = min((h for h in spans if h[0] <= mid <= h[1]), key=lambda h: h[0], default=None)
        op = None
        for k in range(bisect.bisect_right(starts, mid) - 1, max(-1, bisect.bisect_right(
                starts, mid) - 1 - 256), -1):
            if ops[k][1] >= mid:
                op = ops[k]
                break
        label = " / ".join(x[2][:NAME_CHARS // 2] for x in (span, op) if x is not None) \
            or "no host operation"
        idle[label] += (b - a) / 1e6
    rest = sum(b - a for a, b in gaps[LABELLED_GAPS:]) / 1e6
    if rest:
        idle[f"gaps shorter than the {LABELLED_GAPS} longest"] += rest
    return sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
