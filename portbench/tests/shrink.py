"""Cells of ``BENCHMARK.json`` (or ``portbench/pending/``) shrunk to a size
the CPU runs in seconds."""

import dataclasses

from pb import spec


def small_cell(name: str, **limits) -> spec.Cell:
    """``name``'s cell with 2 clouds (serve: 4 requests a second, batches of
    up to 2), 8 grasps and 4 sampler steps; the widths stay as published."""
    c = spec.cell(name, pending=True)
    mix = dict(c.traffic)
    if mix["rig"] == "batch":
        mix.update(clouds_per_call=2, grasps=8)
    else:
        mix.update(rate_per_s=4.0, check_requests=4, warm_requests=1, num_grasps=8)
        mix["server"] = dict(mix["server"], grasps=8, max_batch=2)
    if "steps" in mix:
        mix["steps"] = 4
    return dataclasses.replace(c, traffic=mix, limits=dict(c.limits, **limits))
