"""setup_s (host clock): process start to the first timed call, warm-up
included (a checkout's first run also builds the kernels)."""


def read(run):
    return run.setup_s
