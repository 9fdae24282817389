"""100 (1 - busy / window) over the profiled slice of a cell whose window
completes frames: busy is the union of the device's operation intervals."""


def read(rec):
    s = rec.slice
    if s is None or s["unit"] != "frames" or not s["n_ops"] or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
