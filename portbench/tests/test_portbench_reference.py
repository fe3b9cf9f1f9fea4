"""The plain reference against the program's plain CPU path, at a small
size (the published widths, few rows and steps), for both configurations.
This test may import both; the reference itself imports nothing of the
program (test_portbench_imports.py)."""

import numpy as np
import pytest
import torch

from pb import program, spec, traffic, weights
from reference import model as ref
from reference.generate import generate

CONFIGS = ("graspldm-fpc-z4-pc64", "graspldm-ppc-z16-pc256")


def config(name):
    return spec.load_json(spec.BENCH_DIR / "configs" / f"{name}.json")


@pytest.mark.parametrize("name", CONFIGS)
def test_state_dict_key_space_is_the_programs(name):
    cfg = config(name)
    r_vae, r_ddm = ref.build(cfg, "cpu")
    from graspldm_tpu_torch.flagship import build_flagship

    p_vae, p_ddm, _ = build_flagship(program.flagship_config(cfg), device="cpu")
    for r, p in ((r_vae, p_vae), (r_ddm, p_ddm)):
        want = {k: tuple(v.shape) for k, v in p.state_dict().items()}
        assert {k: tuple(v.shape) for k, v in r.state_dict().items()} == want


@pytest.mark.parametrize("name,entry", [(CONFIGS[0], "ldm"), (CONFIGS[1], "ldm"),
                                        (CONFIGS[0], "vae")])
def test_reference_matches_the_programs_plain_path(name, entry):
    cfg = config(name)
    torch.manual_seed(0)
    ldm = entry == "ldm"
    r_vae, r_ddm = weights.make(cfg, 123456789012, "cpu", with_denoiser=ldm)
    prog = program.build(cfg, {"vae": r_vae.state_dict(),
                               "ddm": r_ddm.state_dict() if ldm else None}, "cpu", ldm=ldm)
    B, G, steps = 2, 8, 5
    mix = {"clouds": "partial" if "ppc" in name else "full", "clouds_per_call": B, "points": 1024}
    pc = torch.from_numpy(traffic.call_clouds(mix, 7, 0))
    lat = torch.randn(B * G, cfg["grasp_latent_size"])
    got = program.generate(prog, pc, G, lat, steps, "ddim")
    want = generate(r_vae, r_ddm, cfg, pc, G, torch.arange(B * G), lat, steps if ldm else 0,
                    spec.plugin("reference/samplers", "ddim"))
    for k in program.OUT_KEYS:
        g = got[k].reshape((B * G,) + tuple(got[k].shape[2:])).numpy()
        w = want[k].numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() < 1e-4, k
    assert np.abs(want["grasp_tmrp"].numpy()).max() > 1e-2  # not trivially zero


def test_weights_are_drawn_from_the_seed():
    cfg = config(CONFIGS[0])
    a = weights.make(cfg, 5, "cpu")[1].state_dict()
    b = weights.make(cfg, 5, "cpu")[1].state_dict()
    c = weights.make(cfg, 6, "cpu")[1].state_dict()
    key = "blocks.1.0.block1.proj.weight"
    assert torch.equal(a[key], b[key]) and not torch.equal(a[key], c[key])
    assert all(torch.isfinite(v.float()).all() for v in a.values())
