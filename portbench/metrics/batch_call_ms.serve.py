"""batch_call_ms.serve (host clock): the median length of the harness's
span around each call of the program that the window made (in a serve
cell, each call of the batch callable that the batcher ran)."""

import statistics


def read(run):
    if not run.calls:
        return None
    return 1e3 * statistics.median(c["end"] - c["start"] for c in run.calls)
