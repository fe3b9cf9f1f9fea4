"""The open-loop HTTP client of a serve cell, run as a process of its own
(so that its interpreter lock does not contend with the server's).

    python3 portbench/pb/client.py --mix '{...}' --seed S --seconds T

It makes the window's request bodies from the seed (:mod:`pb.traffic`),
reads the server's port as a line on standard input, sends its warm-up
requests one at a time, prints ``READY`` and waits for another line. Then it sends each request at its due time from a
pool of threads, whatever is still outstanding, and times it from its due
time to the end of its reply. Once every request has its reply (or failed,
or waited ``--timeout`` seconds) it prints one JSON line with each
request's timeline, then each request's reply body on a line of its own
("" where none came). Imports only the standard library and numpy.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import queue
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pb import spec, traffic  # noqa: E402


def body(mix: dict, seed: int, k: int, points: int) -> bytes:
    pts = traffic.request_cloud(mix, seed, k, points)
    return json.dumps({"points": pts.tolist(), "num_grasps": mix["num_grasps"]}).encode()


def post(port: int, data: bytes, timeout: float):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/v1/generate", data, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--mix", required=True, help="the traffic mix's parameters, as JSON")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--timeout", type=float, default=120.0)
    p.add_argument("--root", default=str(spec.ROOT), help="the checkout (arrival laws)")
    a = p.parse_args(argv)
    mix = json.loads(a.mix)
    plan = traffic.serve_schedule(mix, a.seed, a.seconds, Path(a.root))
    bodies = [body(mix, a.seed, k, r["points"]) for k, r in enumerate(plan)]
    port = int(sys.stdin.readline())
    for k in range(1, mix["warm_requests"] + 1):
        status, _ = post(port, body(mix, a.seed, -k, plan[k % len(plan)]["points"]), a.timeout)
        if status != 200:
            print(f"warm-up request {k}: HTTP {status}", file=sys.stderr)
            return 1
    print("READY", flush=True)
    sys.stdin.readline()

    recs = [{"due": r["due"], "points": r["points"], "sent": None, "done": None, "status": None}
            for r in plan]
    replies = [b""] * len(plan)
    todo: "queue.Queue[int | None]" = queue.Queue()

    def worker():
        while (k := todo.get()) is not None:
            recs[k]["sent"] = time.perf_counter() - t0
            try:
                status, data = post(port, bodies[k], a.timeout)
                recs[k]["status"], replies[k] = status, data
            except OSError as e:  # refused, reset or timed out: the request failed
                recs[k]["status"] = repr(e)
            recs[k]["done"] = time.perf_counter() - t0

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(mix["client_threads"])]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for k, r in enumerate(plan):
        wait = t0 + r["due"] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        todo.put(k)
    for _ in threads:
        todo.put(None)
    for t in threads:
        t.join(a.timeout + 10.0)
    out = sys.stdout
    out.write(json.dumps({"requests": recs, "end": time.perf_counter() - t0}) + "\n")
    for data in replies:
        out.write(data.decode() + "\n")
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
