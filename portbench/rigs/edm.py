"""The ``edm`` rig: the ``batch`` rig's closed loop (one caller, each call a
fresh batch of clouds, the next call's inputs made while the card runs
this one) on the program in GraspLDM's EDM mode (:mod:`pb.edm`).

Both sides start from ``x_T = sigma_max * N(0, I)`` drawn from the seed and
the call's index (DPM-Solver++(2M) draws nothing more). Each call's record
also holds what the program's host-time counter of the sampler's tables
(``graspldm_tpu_torch.utils.profiling.SAMPLER_TABLES``) gained over the
call, ``sampler_tables`` (``calls`` and seconds ``s``); None where the
program has no such counter.

The check compares the same outputs as the ``batch`` rig's, but by rows
(:func:`row_numbers`): each quantity's mean and 99th percentile over the
checked rows of a row's largest gap, where ``pb.compare`` takes the largest
gap of all. With random weights a few rows of a call (43 of 16,384 over
1e-4 on the worst seed read) leave the 32-step trajectory ill-conditioned in
float32: there the float32 reference errs as far from a float64 one as the
program does, up to 7e-2, above the largest gap of the bfloat16 control on
other seeds. A loss of precision moves every row, and the mean and the 99th
percentile see it: the limits lie 14-50 x above the program's largest
readings and 17-44 x below the control's smallest (PERF.md §2).
"""

from __future__ import annotations

import math
import time
from pathlib import Path

import numpy as np
import torch

from pb import edm, spec, traffic, weights
from pb.checks import grasp_faults, pose_faults
from pb.clouds import rng_for
from pb.compare import GRASP_STD
from reference.generate import generate as reference_generate

batch = spec.plugin("rigs", "batch", Path(__file__).resolve().parents[2])


# number prefix -> (output, scale of its entries)
QUANTITIES = {"tmrp": ("grasp_tmrp", GRASP_STD), "pose": ("grasps", 1.0),
              "conf": ("confidence", 1.0)}


def row_numbers(got: dict, want: dict) -> dict:
    """``<q>_mean_err`` and ``<q>_p99_err`` for each quantity of
    :data:`QUANTITIES`: a row's gap is the largest over its entries (each
    divided by its scale, as in ``pb.compare``); then their mean and their
    99th percentile over the rows. Not finite anywhere: inf."""
    out = {}
    for q, (key, scale) in QUANTITIES.items():
        d = np.abs(np.asarray(got[key], np.float64) - np.asarray(want[key], np.float64)) / scale
        d = d.reshape(len(d), -1).max(axis=1)
        finite = bool(np.isfinite(d).all())
        out[f"{q}_mean_err"] = float(d.mean()) if finite else math.inf
        out[f"{q}_p99_err"] = float(np.quantile(d, 0.99)) if finite else math.inf
    return out


class Rig(batch.Rig):
    def __init__(self, cell: spec.Cell, seed: int, seconds: float, device, tracer,
                 control: bool = False):
        cfg, mix = cell.config, cell.traffic
        if mix["entry"] != "ldm" or cfg.get("diffusion") != "edm":
            raise ValueError("the edm rig runs LDM generation of an EDM configuration")
        self.cfg, self.mix, self.seed, self.device, self.tracer = cfg, mix, seed, device, tracer
        self.ldm, self.steps = True, mix["steps"]
        self.sampler = spec.plugin("reference/samplers", mix["sampler"], cell.root)
        self.draws = self.sampler.draws(cfg, self.steps)
        t = time.perf_counter()
        self.ref_vae, self.ref_ddm = weights.make(cfg, seed, device)
        state = {"vae": self.ref_vae.state_dict(), "ddm": self.ref_ddm.state_dict()}
        t1 = time.perf_counter()
        self.prog = edm.build(cfg, state, device, self.steps, control)
        self.phases = {"weights": t1 - t, "program": time.perf_counter() - t1}
        self.B, self.G = mix["clouds_per_call"], mix["grasps"]
        self.gen = torch.Generator(device=device)
        from graspldm_tpu_torch.utils import profiling

        self.counter, self.tables = getattr(profiling, "SAMPLER_TABLES", None), {}

    def latents(self, i: int):
        """Call ``i``'s x_T at sigma_max scale, and the sampler's noise."""
        lat, noise = super().latents(i)
        return self.cfg["sigma_max"] * lat, noise

    def call(self, i: int, pcs, lat: tuple, then=None):
        c = self.counter
        if c is None:
            return super().call(i, pcs, lat, then)
        n, s = c.calls, c.seconds
        try:
            return super().call(i, pcs, lat, then)
        finally:
            self.tables[i] = {"calls": c.calls - n, "s": c.seconds - s}

    def window(self, seconds: float) -> dict:
        self.tables = {}
        win = super().window(seconds)
        for c in win["calls"]:
            c["sampler_tables"] = self.tables.get(c["i"])
        return win

    def check(self, win: dict) -> tuple:
        """``(numbers, faults)`` as the ``batch`` rig's, with
        :func:`row_numbers` for the numbers."""
        calls = win["calls"]
        faults = [f"call {c['i']}: {c['error']}" for c in calls if c["error"]]
        done = [c for c in calls if c["out"] is not None]
        for c in done:
            faults += [f"call {c['i']}: {f}" for f in grasp_faults(c["out"], self.B, self.G)
                       + pose_faults(c["out"]["grasps"])]
        if not done:
            return {}, faults + ["no call completed"]
        pick = rng_for(self.seed, "check", 0).choice(
            len(done), size=min(self.mix["check_calls"], len(done)), replace=False)
        got, want = {}, {}
        rows = torch.arange(self.B * self.G, device=self.device)
        for k in sorted(pick):
            c = done[k]
            pc = torch.from_numpy(traffic.call_clouds(self.mix, self.seed, c["i"])).to(self.device)
            lat, noise = self.latents(c["i"])
            ref = reference_generate(self.ref_vae, self.ref_ddm, self.cfg, pc, self.G, rows,
                                     lat, self.steps, self.sampler, noise)
            for key, _ in QUANTITIES.values():
                v = c["out"][key]
                got.setdefault(key, []).append(v.reshape((-1,) + v.shape[2:]))
                want.setdefault(key, []).append(ref[key].cpu().numpy())
        got = {k: np.concatenate(v) for k, v in got.items()}
        want = {k: np.concatenate(v) for k, v in want.items()}
        return row_numbers(got, want), faults
