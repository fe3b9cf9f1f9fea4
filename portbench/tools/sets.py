#!/usr/bin/env python3
"""Measure a cell as the benchmark's checks do: each run a process of its
own (``portbench/run.py``), two sets of the same seeds, then traced runs;
prints each run's metrics and, per set, each metric's median and spread
(``pb.stats.spread``: quartile distance over the median). From the
repository root on the card:

    python3 portbench/tools/sets.py --workload fpc.batch --seconds 20 --runs 6 --traced 3

Each run's line is also appended to ``--out`` (JSON lines).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from pb.stats import spread  # noqa: E402

RUN = os.path.join(os.path.dirname(HERE), "run.py")


def run(workload: str, seed: int, seconds: float, trace: int) -> dict:
    t = time.perf_counter()
    p = subprocess.run([sys.executable, RUN, "--workload", workload, "--seed", str(seed),
                        "--seconds", str(seconds), "--trace", str(trace)],
                       capture_output=True, text=True)
    lines = p.stdout.strip().splitlines()
    return {"workload": workload, "seed": seed, "trace": trace, "rc": p.returncode,
            "wall_s": time.perf_counter() - t,
            "result": json.loads(lines[-1]) if lines and lines[-1].startswith("{") else {},
            "stderr": p.stderr.strip().splitlines()[-6:]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--runs", type=int, default=6, help="runs a set (two sets, the same seeds)")
    p.add_argument("--traced", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_100_000_001)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    seeds = [a.first_seed + 104729 * k for k in range(a.runs)]
    plan = [(s, seed, 0) for s in range(2 if a.runs else 0) for seed in seeds]
    plan += [("traced", a.first_seed + 7 + 15485863 * k, 1) for k in range(a.traced)]
    sets = {}
    for label, seed, trace in plan:
        r = dict(run(a.workload, seed, a.seconds, trace), set=label)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(r) + "\n")
        res = r["result"]
        print(label, seed, "rc", r["rc"], "correct", res.get("correct"), f"{r['wall_s']:.1f} s",
              {k: v["value"] for k, v in res.get("metrics", {}).items()},
              {k: res.get("device", {}).get(k)
               for k in ("busy_s", "window_s", "memory_peak_bytes")},
              flush=True)
        if r["rc"] or not res.get("correct"):
            print("  not correct:", r["stderr"], flush=True)
        sets.setdefault(label, []).append(res)
    for label, results in sets.items():
        names = sorted({k for res in results for k in res.get("metrics", {})})
        for n in names:
            v = [res["metrics"][n]["value"] for res in results if n in res.get("metrics", {})]
            print(f"set {label} {n}: median {statistics.median(v):.6g} spread {spread(v)}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
