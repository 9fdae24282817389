"""LM iterations per second over the traced run's window: the iterations
whose chunk's result reached the host, over the window's seconds, the
profiled slice at its end included and the time to read its trace left
out.  The host's dispatch of the eager LM step sets it; the spans' hooks
synchronise around each Schur solve in this window."""


def read(rec):
    if rec.unit != "iters" or rec.window_s <= 0 or rec.units <= 0:
        return None
    return rec.units / rec.window_s
