"""Mean ms a call of the reduced camera system's solve bundle adjustment makes (spd_solve), one an LM iteration, from a span with a
device synchronise at each end, over the window after the profiled slice."""

SPAN = ("schur_solve", "mcptam_tpu_torch.ba.bundle", "spd_solve")


def read(rec):
    d = rec.spans.get(SPAN[0])
    if not d:
        return None
    return 1e3 * sum(d) / len(d)
