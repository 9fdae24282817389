"""Device time per LM iteration: the union of the device's operation
intervals over the profiled slice, which every run of a cell whose window
completes iters profiles at the window's end, over the slice's iterations
(harness/trace.py).  The card's cost of an iteration, apart from the
host's dispatch, which ``ba_iters_per_s.host`` reads."""


def read(rec):
    s = rec.slice
    if s is None or s["unit"] != "iters" or not s["n_ops"] or not s["units"]:
        return None
    return 1e3 * s["busy_s"] / s["units"]
