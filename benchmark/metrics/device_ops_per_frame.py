"""Device operations (kernels, copies, sets) in the profiled slice per frame."""


def read(rec):
    s = rec.slice
    if s is None or s["unit"] != "frames" or not s["n_ops"] or not s["units"]:
        return None
    return s["n_ops"] / s["units"]
