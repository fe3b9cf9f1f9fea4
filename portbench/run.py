#!/usr/bin/env python3
"""The benchmark of graspldm_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload fpc.batch --seed 7 --seconds 20 --trace 0

Run from the root of a checkout on a machine with the cards the cell asks
for. It builds the program's kernels on first use (into the checkout),
draws weights and inputs from ``--seed``, warms up every shape the cell
uses, measures for ``--seconds`` seconds (``--trace 1``: under
``torch.profiler``, for the per-layer metrics), checks what the timed
path produced against the plain reference in ``portbench/reference/``,
prints each compared number beside its limit as the last lines of
standard error, and prints the result as one JSON line, the last of
standard output. It exits non-zero, with no result, without the cards, or
if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(1, os.path.dirname(HERE))  # the program, beside the benchmark

from pb import imports, spec  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cell = spec.cell(a.workload)

    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell needs {chips} CUDA device(s); this machine has {n}", file=sys.stderr)
        return 2
    from pb.harness import run_cell

    out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), cell=cell)
    found = imports.forbidden_loaded()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark may not", file=sys.stderr)
        return 3
    for n in out.notes:
        print(n, file=sys.stderr)
    for f in out.faults:
        print(f"fault: {f}", file=sys.stderr)
    for c in out.checks:
        print(f"check {c['name']} {c['value']:.6g} limit {c['limit']:.6g} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out.result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
