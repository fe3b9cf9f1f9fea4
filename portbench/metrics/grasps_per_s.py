"""grasps_per_s (host clock): grasps returned to the host by the window's
completed calls, over the window's seconds (to the last call's return)."""

from pb.stats import rate


def read(run):
    if not run.calls or "grasps" not in run.calls[0]:
        return None
    return rate([(c["end"], c["grasps"]) for c in run.calls], run.window_s)
