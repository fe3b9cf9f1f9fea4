"""device_idle_pct (device trace): the share of the traced window in which
no operation ran on the device. One file for every cell: the metric's
name takes a tag (``device_idle_pct.batch``, ``.serve``) where the cells
report different end-to-end metrics."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
