"""The ``serve`` rig: open-loop cells, the program's ``GraspServer`` on an
ephemeral localhost port, fed by :mod:`pb.client` in a process of its
own (see ``batch.py`` for what a rig gives).

The server runs as the program's own serving tool sets it up
(``make_batch_generate_from_parts`` -> ``DynamicBatcher`` ->
``GraspServer``); the harness only wraps the batch callable it hands to
the batcher, to record each call: the clouds in, the outputs out and the
call's span. That record is how a reply is tied to its row and how the
reference redoes a batch: the callable draws each batch's x_T from one
``torch.Generator`` seeded by the harness, in call order, so the same seed
and the same sequence of batch sizes give the reference the same draws.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from pb import program, spec, traffic, weights
from pb.checks import grasp_faults, pose_faults
from pb.clouds import rng_for
from pb.compare import numbers
from reference.generate import encode, from_latents

CLIENT = spec.BENCH_DIR / "pb" / "client.py"
GRACE_S = 60.0  # how long a reply may come after the window closes


def _rows_key(tmrp: np.ndarray) -> bytes:
    return np.ascontiguousarray(tmrp, np.float32).tobytes()


def _point_set(pc: np.ndarray) -> set:
    return {r.tobytes() for r in np.ascontiguousarray(pc, np.float32)}


def regularized_from(cloud: np.ndarray, request: np.ndarray) -> str:
    """What is wrong with ``cloud`` as the batcher's regularization of
    ``request`` to ``len(cloud)`` points ("" if nothing): a subsample
    without repeats, or the request in order followed by resampled points
    of it. The program draws the resampled points unseeded, so they are
    judged by what they may be, not redrawn."""
    n, m = len(request), len(cloud)
    rows = _point_set(request)
    if any(r.tobytes() not in rows for r in cloud):
        return "the batch row holds points that the request did not send"
    if n >= m and len(_point_set(cloud)) != m:
        return "the subsample repeats points"
    if n < m and not np.array_equal(cloud[:n], request):
        return "the padded cloud does not start with the request"
    return ""


class Rig:
    def __init__(self, cell: spec.Cell, seed: int, seconds: float, device, tracer,
                 control: bool = False):
        from graspldm_tpu_torch.serving import (
            DynamicBatcher, GraspServer, make_batch_generate_from_parts,
        )

        cfg, mix = cell.config, cell.traffic
        self.cfg, self.mix, self.seed, self.device, self.tracer = cfg, mix, seed, device, tracer
        self.root = cell.root
        self.sampler = spec.plugin("reference/samplers", mix["sampler"], cell.root)
        if self.sampler.draws(cfg, mix["steps"]):
            raise ValueError(f"sampler {mix['sampler']!r} draws noise inside the served path; "
                             "the serve rig redraws x_T alone")
        self.client = None
        self.start_client(seconds)  # it makes the window's bodies while the program loads
        t = time.perf_counter()
        self.ref_vae, self.ref_ddm = weights.make(cfg, seed, device)
        t1 = time.perf_counter()
        vae, ddm, diffusion = program.models(
            cfg, {"vae": self.ref_vae.state_dict(), "ddm": self.ref_ddm.state_dict()}, device,
            control)
        srv = mix["server"]
        self.G = srv["grasps"]
        self.gen_seed = traffic.derived_seed(seed, "server", 0)
        fn = make_batch_generate_from_parts(
            vae, ddm, diffusion, device=device, num_grasps=self.G,
            num_inference_steps=mix["steps"], sampler=mix["sampler"], seed=self.gen_seed)
        self.calls = []
        lock = threading.Lock()

        def recorded(pcs, cls):
            with lock, tracer.span("batch_call"):
                t0 = time.perf_counter()
                try:
                    out = fn(pcs, cls)
                except Exception as e:
                    self.calls.append({"pcs": pcs, "out": None, "error": repr(e), "t0": t0,
                                       "t1": time.perf_counter()})
                    raise
                self.calls.append({"pcs": pcs, "out": out, "error": None, "t0": t0,
                                   "t1": time.perf_counter()})
                return out

        self.recorded = recorded
        self.batcher = DynamicBatcher(recorded, num_points=cfg["pc_num_points"],
                                      max_batch=srv["max_batch"], max_wait_ms=srv["max_wait_ms"],
                                      requires_cls=False)
        self.server = GraspServer(self.batcher, host="127.0.0.1", port=0,
                                  info={"num_grasps": self.G})
        self.server.start_background()
        self.phases = {"weights": t1 - t, "program": time.perf_counter() - t1}

    def start_client(self, seconds: float) -> None:
        """Start the client of a window of ``seconds``: it makes every body
        of the window, then waits for the server's port."""
        self.stop_client()
        self.client = subprocess.Popen(
            [sys.executable, str(CLIENT), "--mix", json.dumps(self.mix), "--seed",
             str(self.seed), "--seconds", str(seconds), "--root", str(self.root)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)

    def stop_client(self) -> None:
        if self.client is not None and self.client.poll() is None:
            self.client.kill()
        if self.client is not None:
            self.client.wait()
        self.client = None

    def warm(self, seconds: float) -> None:
        """One call per batch bucket, and the client's warm-up requests
        through HTTP (a client started for a window before is replaced)."""
        if self.client is None or self.client.poll() is not None:
            self.start_client(seconds)
        self.client.stdin.write(f"{self.server.address[1]}\n".encode())
        self.client.stdin.flush()
        n = self.cfg["pc_num_points"]
        for b in self.batcher.buckets:
            pcs = np.stack([traffic.request_cloud(self.mix, self.seed, -100 - j, n)
                            for j in range(b)])
            self.recorded(pcs, None)
        line = self.client.stdout.readline()
        if line.strip() != b"READY":
            raise RuntimeError(f"the client did not get ready: {line!r}")

    def window(self, seconds: float) -> dict:
        stats0, first = self.batcher.stats(), len(self.calls)
        with self.tracer.window():
            t0 = time.perf_counter()
            self.client.stdin.write(b"GO\n")
            self.client.stdin.flush()
            out, _ = self.client.communicate(timeout=seconds + GRACE_S + 180.0)
            window_s = time.perf_counter() - t0
        stats1 = self.batcher.stats()
        lines = out.decode().split("\n")
        head = json.loads(lines[0])
        requests = head["requests"]
        for r, body in zip(requests, lines[1:1 + len(requests)]):
            r["ok"] = r["status"] == 200 and r["done"] is not None
            r["body"] = body
        return {"requests": requests, "window_s": window_s,
                "calls": [dict(c, start=c["t0"] - t0, end=c["t1"] - t0)
                          for c in self.calls[first:]],
                "batcher": {k: stats1[k] - stats0[k] for k in ("requests", "batches", "errors")}}

    def free_program(self) -> None:
        """Stop the client and the server and drop the program's state."""
        self.stop_client()
        if self.server is not None:
            self.server.shutdown()
        self.server = self.batcher = self.recorded = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def tally(self, win: dict) -> tuple:
        """``(attempted, failed)``: the window's requests."""
        return len(win["requests"]), sum(not r["ok"] for r in win["requests"])

    def check(self, win: dict) -> tuple:
        """``(numbers, faults)``: the reference against the HTTP replies of
        ``check_requests`` requests drawn from the seed."""
        reqs = win["requests"]
        faults = [f"request {k}: HTTP {r['status']}" for k, r in enumerate(reqs) if not r["ok"]]
        for c in self.calls:
            if c["error"]:
                faults.append(f"batch call: {c['error']}")
        ok = [k for k, r in enumerate(reqs) if r["ok"]]
        if not ok:
            return {}, faults + ["no request completed"]
        pick = sorted(rng_for(self.seed, "check", 0).choice(
            ok, size=min(self.mix["check_requests"], len(ok)), replace=False).tolist())
        where = {}
        for c, call in enumerate(self.calls):
            if call["out"] is not None:
                for j, t in enumerate(call["out"]["grasp_tmrp"]):
                    where[_rows_key(t[:self.mix["num_grasps"]])] = (c, j)
        need, got = {}, {}
        for k in pick:
            rep = json.loads(reqs[k]["body"])
            out = {key: np.asarray(rep[key], np.float64) for key in program.OUT_KEYS}
            g = rep["num_grasps"]
            bad = grasp_faults({key: v[None] for key, v in out.items()}, 1,
                               self.mix["num_grasps"]) + pose_faults(out["grasps"])
            hit = where.get(_rows_key(out["grasp_tmrp"]))
            if g != self.mix["num_grasps"]:
                bad.append(f"num_grasps {g}")
            if hit is None:
                bad.append("the reply matches no row that the batch callable returned")
            else:
                cloud = self.calls[hit[0]]["pcs"][hit[1]]
                req = traffic.request_cloud(self.mix, self.seed, k, reqs[k]["points"])
                why = regularized_from(cloud, req)
                if why:
                    bad.append(why)
            faults += [f"request {k}: {f}" for f in bad]
            if not bad:
                need.setdefault(hit[0], []).append(hit[1])
                got[k] = out
        if not need:
            return {}, faults
        return self._reference(need, got, pick, where), faults

    def _reference(self, need: dict, got: dict, pick: list, where: dict) -> dict:
        """Redo the needed rows, with the draws the same seed gives, in one
        reference pass."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.gen_seed)
        L, g = self.cfg["grasp_latent_size"], self.mix["num_grasps"]
        z_pc, mean, lat, order = [], [], [], []
        for c, call in enumerate(self.calls):
            x = torch.randn((len(call["pcs"]) * self.G, L), generator=gen, device=self.device)
            if c not in need:
                continue
            z, m = encode(self.ref_vae, torch.from_numpy(call["pcs"]).to(self.device))
            for j in need[c]:
                z_pc.append(z[j:j + 1].expand(g, -1, -1))
                mean.append(m[j:j + 1].expand(g, -1))
                lat.append(x[j * self.G:j * self.G + g])
                order.append((c, j))
        ref = from_latents(self.ref_vae, self.ref_ddm, self.cfg, torch.cat(z_pc), torch.cat(mean),
                           torch.cat(lat), self.mix["steps"], self.sampler)
        ref = {k: v.cpu().numpy().reshape((len(order), g) + v.shape[1:]) for k, v in ref.items()}
        want = {cj: {k: v[i] for k, v in ref.items()} for i, cj in enumerate(order)}
        keys = [k for k in pick if k in got]
        a = {key: np.concatenate([got[k][key] for k in keys]) for key in program.OUT_KEYS}
        b = {key: np.concatenate([want[where[_rows_key(got[k]["grasp_tmrp"])]][key]
                                  for k in keys]) for key in program.OUT_KEYS}
        return numbers(a, b)
