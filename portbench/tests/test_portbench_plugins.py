"""A configuration, traffic mixes, limits, a per-layer metric, an arrival
law and a reference sampler added as files and entries, with no edit to a
file the benchmark has, are found by name and run."""

import json
import shutil

import numpy as np

from pb import spec, traffic
from pb.harness import run_cell

# read by the host's clock, so from the untraced window even in a traced run
DUMMY_METRIC = '''"""dummy_metric: the number of calls in the untraced window."""


def read(run):
    return None if run.trace is not None else float(len(run.calls))
'''

# a law the benchmark does not have: one request every 1 / rate seconds
EVEN_ARRIVALS = '''"""Even arrivals: one request every 1 / rate_per_s seconds."""

import numpy as np


def gaps(mix, k, rng):
    return np.full(k, 1.0 / mix["rate_per_s"])
'''

# a sampler the benchmark does not have: ancestral DDPM with the fixed-large
# variance, which draws one noise row a step besides x_T
DDPM_SAMPLER = '''"""DDPM, ancestral, fixed-large variance, x_0 clipped to [-1, 1]."""

import torch


def evaluations(steps):
    return steps


def draws(cfg, steps):
    T = cfg["diffusion_timesteps"]
    return len(range(0, T, T // steps))


def sample(ddm, cfg, x, z_pc, steps, noise=None):
    assert cfg["variance_type"] == "fixed_large"
    T = cfg["diffusion_timesteps"]
    stride = T // steps
    betas = torch.linspace(cfg["beta_start"], cfg["beta_end"], T, dtype=torch.float32)
    acp = torch.cumprod(1.0 - betas, dim=0).to(x.device)
    one = torch.ones((), device=x.device)
    x = x[:, None, :]
    for s, t in enumerate(list(range(0, T, stride))[::-1]):
        eps = ddm(x, torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device), z_pc)
        a_t = acp[t]
        a_prev = acp[t - stride] if t - stride >= 0 else one
        alpha = a_t / a_prev
        beta = 1.0 - alpha
        x0 = ((x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)).clamp(-1.0, 1.0)
        x = (torch.sqrt(a_prev) * beta / (1.0 - a_t) * x0
             + torch.sqrt(alpha) * (1.0 - a_prev) / (1.0 - a_t) * x)
        if t - stride >= 0:
            x = x + torch.sqrt(beta) * noise[s][:, None, :]
    return x[:, 0, :]
'''


def _copy(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path / "portbench", json.loads((tmp_path / "BENCHMARK.json").read_text())


def _add_cell(bench, name, config, mix, e2e):
    bench["workloads"].append({"name": name, "config": config, "traffic": mix, "chips": 1,
                               "why": "a test"})
    next(m for m in bench["end_to_end"] if m["name"] == e2e)["workloads"].append(name)


def test_new_files_and_entries_are_found_by_name(tmp_path):
    b, bench = _copy(tmp_path)
    cfg = spec.load_json(b / "configs" / "graspldm-fpc-z4-pc64.json")
    (b / "configs" / "dummy-config.json").write_text(json.dumps(dict(cfg, name="dummy-config")))
    (b / "reference" / "samplers" / "ddpm.py").write_text(DDPM_SAMPLER)
    (b / "traffic" / "dummy-mix.json").write_text(json.dumps({
        "rig": "batch", "entry": "ldm", "clouds": "partial", "points": 1024,
        "clouds_per_call": 1, "grasps": 8, "sampler": "ddpm",
        "sampler_kernel": "ddim_sampler_kernel", "steps": 4, "check_calls": 1}))
    (b / "limits" / "dummy.cell.json").write_text(json.dumps({"tmrp_err": 1e-3}))
    (b / "metrics" / "dummy_metric.py").write_text(DUMMY_METRIC)
    bench["configs"].append({"name": "dummy-config", "source": "https://example.org/dummy",
                             "file": "portbench/configs/dummy-config.json", "reduced": [],
                             "why": "a test"})
    _add_cell(bench, "dummy.cell", "dummy-config", "dummy-mix", "grasps_per_s")
    bench["per_layer"].append({"name": "dummy_metric", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "pipeline",
                               "moves": "grasps_per_s", "workloads": ["dummy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.cell("dummy.cell", root=tmp_path)
    assert cell.config["name"] == "dummy-config" and cell.traffic["sampler"] == "ddpm"
    assert [m["name"] for m in cell.per_layer] == ["dummy_metric"]
    out = run_cell("dummy.cell", 4, 0.5, True, device="cpu", cell=cell)
    assert out.result["correct"], (out.faults, out.checks)
    assert out.result["metrics"]["dummy_metric"]["value"] >= 1.0
    out = run_cell("dummy.cell", 4, 0.5, False, device="cpu", cell=cell)
    assert set(out.result["metrics"]) == {"grasps_per_s", "setup_s"}
    assert out.result["correct"], (out.faults, out.checks)


def test_a_new_arrival_law_is_found_by_name(tmp_path):
    b, _ = _copy(tmp_path)
    bench = spec.with_pending("ppc.serve", tmp_path)  # a serve cell and its metrics
    (b / "arrivals" / "even.py").write_text(EVEN_ARRIVALS)
    mix = dict(spec.load_json(b / "traffic" / "serve-partial-ddim100.json"), arrivals="even",
               rate_per_s=4.0, steps=4, check_requests=4, warm_requests=1, num_grasps=8)
    mix["server"] = dict(mix["server"], grasps=8, max_batch=2)
    (b / "traffic" / "serve-even.json").write_text(json.dumps(mix))
    (b / "limits" / "even.serve.json").write_text(
        (b / "limits" / "ppc.serve.json").read_text())
    _add_cell(bench, "even.serve", "graspldm-ppc-z16-pc256", "serve-even", "latency_p50_ms")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    due = [r["due"] for r in traffic.serve_schedule(mix, 9, 1.0, tmp_path)]
    assert np.allclose(np.diff(due), 0.25)
    cell = spec.cell("even.serve", root=tmp_path)
    out = run_cell("even.serve", 9, 1.0, False, device="cpu", cell=cell)
    assert out.result["correct"], (out.faults, out.checks)
    assert out.result["attempted"] == 4 and "latency_p50_ms" in out.result["metrics"]
