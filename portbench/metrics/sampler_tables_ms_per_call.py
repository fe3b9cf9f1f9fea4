"""sampler_tables_ms_per_call (host clock): the host time of the sampler's
prologue (the time rows and coefficients of every step, built on the host
and copied to the card: the program's ``SAMPLER_TABLES`` counter, the
stretch of the span ``graspldm.sampler_tables``), over the window's
completed calls. A blocking copy there waits for the stream, and that
wait is read too. None where the program has no such counter."""


def read(run):
    rec = [c.get("sampler_tables") for c in run.calls if c["error"] is None]
    if not rec or any(r is None for r in rec) or not sum(r["calls"] for r in rec):
        return None
    return 1e3 * sum(r["s"] for r in rec) / len(rec)
