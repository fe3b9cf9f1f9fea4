"""latency_p50_ms (host clock): median over every request due in the
window, each timed from its due time to the end of its reply; a failed
request counts as infinitely late."""

from pb.stats import latencies_ms, percentile


def read(run):
    if run.requests is None:
        return None
    return percentile(latencies_ms(run.requests), 50)
