#!/usr/bin/env python3
"""Readings for the limits that decide ``correct``: the numbers compared
(``pb.compare``) over many seeds of the program as the configuration
states it, and over a few seeds of the lower-precision control (the same
program with ``denoiser_dtype="bfloat16"``), each a short window at the
cell's own load, all in one process. On the card, from the repository
root:

    python3 portbench/tools/calibrate.py --workload fpc.batch --seeds 12 --control-seeds 3

Prints one line per run and a JSON summary (the largest program reading
and the smallest control reading of each number) as the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]

from pb import spec  # noqa: E402
from pb.harness import run_cell  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    p.add_argument("--seconds", type=float, default=2.0)
    a = p.parse_args(argv)
    cell = spec.cell(a.workload, pending=True)
    readings = {"program": [], "control": []}
    runs = [("program", s) for s in range(a.seeds)] + \
           [("control", a.seeds + s) for s in range(a.control_seeds)]
    for side, k in runs:
        seed = a.first_seed + 7919 * k
        out = run_cell(a.workload, seed, a.seconds, False, control=side == "control", cell=cell)
        values = {c["name"]: c["value"] for c in out.checks}
        readings[side].append(values)
        print(json.dumps({"side": side, "seed": seed, "values": values,
                          "correct": out.result["correct"], "faults": out.faults[:5],
                          "notes": out.notes}), flush=True)
    names = list(cell.limits)
    summary = {"workload": a.workload,
               "program_max": {n: max(r[n] for r in readings["program"]) for n in names},
               "control_min": {n: min(r[n] for r in readings["control"]) for n in names}
               if readings["control"] else {}}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
