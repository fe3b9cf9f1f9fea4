"""The traffic generator: deterministic per seed, the same work for every seed."""

import numpy as np

from pb import clouds, spec, traffic

SERVE = spec.load_json(spec.BENCH_DIR / "traffic" / "serve-partial-ddim100.json")
BATCH = spec.load_json(spec.BENCH_DIR / "traffic" / "batch16-full-ddim100.json")


def test_every_seed_gets_the_same_sizes_and_gaps_in_another_order():
    a = traffic.serve_schedule(SERVE, 2 ** 31 + 11, 20.0)
    b = traffic.serve_schedule(SERVE, 3, 20.0)
    assert len(a) == len(b) == round(SERVE["rate_per_s"] * 20.0)
    assert sorted(r["points"] for r in a) == sorted(r["points"] for r in b)
    assert [r["points"] for r in a] != [r["points"] for r in b]
    gaps = [np.diff([r["due"] for r in s]) for s in (a, b)]
    assert abs(a[-1]["due"] - b[-1]["due"]) < 0.1 * 20.0
    assert all(g.min() >= 0 for g in gaps)
    sizes = [r["points"] for r in a]
    assert min(sizes) >= SERVE["points_min"] and max(sizes) <= SERVE["points_max"]


def test_inputs_are_drawn_from_the_seed():
    x = traffic.call_clouds(BATCH, 12345678901, 3)
    assert x.shape == (16, 1024, 3) and x.dtype == np.float32
    assert np.array_equal(x, traffic.call_clouds(BATCH, 12345678901, 3))
    assert not np.array_equal(x, traffic.call_clouds(BATCH, 12345678901, 4))
    assert not np.array_equal(x, traffic.call_clouds(BATCH, 12345678902, 3))
    assert traffic.derived_seed(5, "latents", 1) != traffic.derived_seed(5, "latents", 2)


def test_a_partial_view_keeps_the_faces_that_face_the_camera():
    pc = clouds.partial_view(clouds.rng_for(1, "t", 0), 2000).astype(np.float64)
    local = (pc - pc.mean(0)) / clouds.BOX_HALF_EXTENT
    on_face = np.abs(np.abs(local) - np.abs(local).max(0)) < 0.2
    # one face per axis at most: every point's face coordinate has one sign per axis
    for a in range(3):
        face = local[on_face[:, a], a]
        assert len(face) == 0 or (np.sign(face) == np.sign(face[0])).all()


def test_bursty_arrivals_keep_the_mean_rate_in_bursts():
    mix = dict(SERVE, arrivals="bursty", burst=8)
    plan = traffic.serve_schedule(mix, 77, 30.0)
    due = np.array([r["due"] for r in plan])
    assert len(plan) == round(SERVE["rate_per_s"] * 30.0)
    gaps = np.diff(due)
    assert (gaps[np.arange(len(gaps)) % 8 != 7] == 0.0).all()  # 8 at once
    assert abs(due[-1] - 30.0) < 0.25 * 30.0  # the mean rate holds
    poisson = [r["points"] for r in traffic.serve_schedule(SERVE, 77, 30.0)]
    assert sorted(r["points"] for r in plan) == sorted(poisson)
