"""Rate and latency arithmetic on synthetic timelines."""

import math
import statistics

import pytest

from pb import stats


def closed_loop(n, call_s, stall_at=None, stall_s=0.0):
    """A caller making ``n`` calls of ``call_s`` each; a stall of ``stall_s``
    before call ``stall_at``."""
    t, done = 0.0, []
    for i in range(n):
        if i == stall_at:
            t += stall_s
        t += call_s
        done.append((t, 1000))
    return done, t


def open_loop(gap_s, service_s, n, stall=None):
    """Requests due every ``gap_s`` to one FIFO server taking ``service_s``
    each; ``stall = (at, length)`` halts the server."""
    free, reqs = 0.0, []
    for k in range(n):
        due = k * gap_s
        start = max(due, free)
        if stall and start < stall[0] + stall[1] and start + service_s > stall[0]:
            start = stall[0] + stall[1]
        free = start + service_s
        reqs.append({"due": due, "sent": due, "done": free, "ok": True})
    return reqs


def test_a_stall_lowers_the_rate():
    done, end = closed_loop(20, 0.5)
    stalled, end2 = closed_loop(20, 0.5, stall_at=10, stall_s=2.0)
    assert stats.rate(done, end) == pytest.approx(2000.0)
    assert stats.rate(stalled, end2) == pytest.approx(20000 / 12.0)


def test_a_stall_raises_the_tail():
    calm = stats.latencies_ms(open_loop(0.1, 0.05, 200))
    stalled = stats.latencies_ms(open_loop(0.1, 0.05, 200, stall=(5.0, 1.0)))
    assert stats.percentile(calm, 95) == pytest.approx(50.0)
    assert stats.percentile(stalled, 95) > 500.0
    assert stats.percentile(stalled, 50) == pytest.approx(50.0)


def test_latency_is_timed_from_the_due_time():
    late_sender = [{"due": 1.0, "sent": 1.5, "done": 1.6, "ok": True}]
    assert stats.latencies_ms(late_sender) == [pytest.approx(600.0)]


def test_a_failed_request_misses_every_limit():
    reqs = [{"due": 0.0, "done": 0.1, "ok": True}] * 19 + [{"due": 0.0, "done": None, "ok": False}]
    lat = stats.latencies_ms(reqs)
    assert stats.percentile(lat, 95) == pytest.approx(100.0)
    assert stats.percentile(lat, 100) == math.inf


def test_percentile_is_nearest_rank():
    v = list(range(1, 101))
    assert stats.percentile(v, 50) == 50
    assert stats.percentile(v, 95) == 95
    assert stats.percentile([3.0], 95) == 3.0


def test_spread_uses_statistics_quantiles():
    v = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / q2)
    assert stats.spread([1.0]) is None
