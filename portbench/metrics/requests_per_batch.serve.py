"""requests_per_batch.serve (program counter): the batcher's ``requests``
and ``batches`` counters, differenced over the window, as a ratio."""


def read(run):
    if run.batcher is None or not run.batcher["batches"]:
        return None
    return run.batcher["requests"] / run.batcher["batches"]
