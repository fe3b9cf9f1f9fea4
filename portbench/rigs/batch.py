"""The ``batch`` rig: closed-loop cells, one caller, each call a fresh
batch of clouds.

A rig is found by the mix's ``rig`` name and gives ``Rig(cell, seed,
seconds, device, tracer, control)`` with ``warm(seconds)``, ``window(seconds) ->
win``, ``free_program()``, ``check(win) -> (numbers, faults)``,
``tally(win) -> (attempted, failed)`` and ``phases`` (set-up seconds by
part, for standard error).

A call copies its clouds to the card, normalises them, runs the program's
generation entry with the pre-packed weights and its starting latents,
and copies the grasps back to the host. Its inputs (clouds on the host,
latents on the card, both from the seed and the call's index) are made
while the card runs the call before, as a caller preparing its next batch
would; the next call starts when the last has returned.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pb import program, spec, traffic, weights
from pb.checks import grasp_faults, pose_faults
from pb.clouds import rng_for
from pb.compare import numbers
from reference.generate import generate as reference_generate


class Rig:
    def __init__(self, cell: spec.Cell, seed: int, seconds: float, device, tracer,
                 control: bool = False):
        cfg, mix = cell.config, cell.traffic
        self.cfg, self.mix, self.seed, self.device, self.tracer = cfg, mix, seed, device, tracer
        self.ldm = mix["entry"] == "ldm"
        self.steps = mix.get("steps", 0)
        self.sampler = spec.plugin("reference/samplers", mix["sampler"], cell.root) \
            if self.ldm else None
        self.draws = self.sampler.draws(cfg, self.steps) if self.ldm else 0
        t = time.perf_counter()
        self.ref_vae, self.ref_ddm = weights.make(cfg, seed, device, with_denoiser=self.ldm)
        state = {"vae": self.ref_vae.state_dict(),
                 "ddm": self.ref_ddm.state_dict() if self.ldm else None}
        t1 = time.perf_counter()
        self.prog = program.build(cfg, state, device, control, ldm=self.ldm)
        self.phases = {"weights": t1 - t, "program": time.perf_counter() - t1}
        self.B, self.G = mix["clouds_per_call"], mix["grasps"]
        self.gen = torch.Generator(device=device)

    def latents(self, i: int):
        """Call ``i``'s ``[B * G, latent]`` x_T (LDM) or z_h (VAE prior), and
        the sampler's ``[draws, B * G, latent]`` noise (None if it draws none)."""
        self.gen.manual_seed(traffic.derived_seed(self.seed, "latents", i))
        shape = (self.B * self.G, self.cfg["grasp_latent_size"])
        lat = torch.randn(shape, generator=self.gen, device=self.device)
        noise = (torch.randn((self.draws,) + shape, generator=self.gen, device=self.device)
                 if self.draws else None)
        return lat, noise

    def inputs(self, i: int):
        """Call ``i``'s clouds (host) and starting latents and noise (card)."""
        with self.tracer.span("inputs"):
            return traffic.call_clouds(self.mix, self.seed, i), self.latents(i)

    def call(self, i: int, pcs: np.ndarray, lat: tuple, then=None) -> dict:
        """One call on inputs made beforehand; ``then()`` runs on the host
        while the card works (it makes the next call's inputs, as a caller
        that prepares its next batch would)."""
        with self.tracer.span("generate"):
            pc = torch.from_numpy(pcs).to(self.device)
            out = program.generate(self.prog, pc, self.G, lat[0], self.steps,
                                   self.mix.get("sampler"), lat[1])
        nxt = then() if then is not None else None
        with self.tracer.span("to_host"):
            return {k: out[k].cpu().numpy() for k in program.OUT_KEYS}, nxt

    def warm(self, seconds: float) -> None:
        """Every shape the window uses: one call at the cell's size."""
        self.call(-1, *self.inputs(-1))

    def window(self, seconds: float) -> dict:
        """Calls until ``seconds`` have passed; the window ends when the last
        call returns."""
        calls, i, nxt = [], 0, self.inputs(0)
        with self.tracer.window():
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                start = time.perf_counter() - t0
                try:
                    out, nxt = self.call(i, *nxt, then=lambda k=i + 1: self.inputs(k))
                    err = None
                except Exception as e:  # a failed call is counted, the loop goes on
                    out, err, nxt = None, repr(e), self.inputs(i + 1)
                calls.append({"i": i, "start": start, "end": time.perf_counter() - t0,
                              "out": out, "error": err,
                              "grasps": 0 if out is None else self.B * self.G})
                i += 1
            window_s = time.perf_counter() - t0
        return {"calls": calls, "window_s": window_s}

    def free_program(self) -> None:
        """Drop the program's models and packed weights."""
        self.prog = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def tally(self, win: dict) -> tuple:
        """``(attempted, failed)``: the window's calls."""
        return len(win["calls"]), sum(c["error"] is not None for c in win["calls"])

    def check(self, win: dict) -> tuple:
        """``(numbers, faults)``: the reference against the program on the
        calls drawn from the seed (``check_calls`` of them), and what the
        structural checks found in every call."""
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
            for key in program.OUT_KEYS:
                v = c["out"][key]
                got.setdefault(key, []).append(v.reshape((-1,) + v.shape[2:]))
                want.setdefault(key, []).append(ref[key].cpu().numpy())
        got = {k: np.concatenate(v) for k, v in got.items()}
        want = {k: np.concatenate(v) for k, v in want.items()}
        return numbers(got, want), faults
