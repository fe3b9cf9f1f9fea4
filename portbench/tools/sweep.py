#!/usr/bin/env python3
"""The knee of a serve cell: the same server offered one fixed rate after
another, each for a window of its own (``--repeats`` windows a rate, each
with the arrivals and clouds of another seed), in one process. On the card, from
the repository root:

    python3 portbench/tools/sweep.py --workload ppc.serve --rates 20 40 60 --seconds 15

For each rate it prints the share of requests answered, p50 / p95 over
the whole window and over its first and last thirds (a backlog that grows
shows as a last third far above the first), how late the client sent,
and the batcher's requests per batch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]

import torch  # noqa: E402

from pb import spec, stats  # noqa: E402
from pb.harness import set_float32  # noqa: E402
from pb.trace import Tracer  # noqa: E402


def thirds(reqs):
    n = len(reqs)
    return reqs[: n // 3], reqs[n - n // 3:]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="ppc.serve")
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--seed", type=int, default=4_000_000_001)
    p.add_argument("--repeats", type=int, default=1, help="windows a rate, each on its own seed")
    a = p.parse_args(argv)
    set_float32()
    cell = spec.cell(a.workload, pending=True)
    rig = spec.plugin("rigs", cell.traffic["rig"]).Rig(cell, a.seed, a.seconds,
                                                        torch.device("cuda"), Tracer(False))
    try:
        for rate, rep in ((r, k) for r in a.rates for k in range(a.repeats)):
            rig.mix = dict(cell.traffic, rate_per_s=rate)
            rig.seed = a.seed + 1009 * rep
            rig.stop_client()  # the next warm-up starts one for this rate and seed
            rig.warm(a.seconds)
            win = rig.window(a.seconds)
            reqs = win["requests"]
            lat = stats.latencies_ms(reqs)
            first, last = (stats.latencies_ms(t) for t in thirds(reqs))
            late = [r["sent"] - r["due"] for r in reqs if r["sent"] is not None]
            print(json.dumps({
                "rate": rate, "seed": rig.seed, "requests": len(reqs),
                "ok": sum(r["ok"] for r in reqs),
                "p50_ms": stats.percentile(lat, 50), "p95_ms": stats.percentile(lat, 95),
                "p95_first_third_ms": stats.percentile(first, 95),
                "p95_last_third_ms": stats.percentile(last, 95),
                "send_late_max_ms": 1e3 * max(late, default=0.0),
                "requests_per_batch":
                    win["batcher"]["requests"] / max(1, win["batcher"]["batches"]),
                "window_s": win["window_s"]}), flush=True)
    finally:
        rig.free_program()
    return 0


if __name__ == "__main__":
    sys.exit(main())
