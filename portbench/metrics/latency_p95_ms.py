"""latency_p95_ms.serve (host clock): the 95th percentile (nearest rank) of
the same sample as latency_p50_ms, read in the traced run (the tail of
untraced runs spread too widely between runs for a bound of 25 %)."""

from pb.stats import latencies_ms, percentile


def read(run):
    if run.requests is None:
        return None
    return percentile(latencies_ms(run.requests), 95)
