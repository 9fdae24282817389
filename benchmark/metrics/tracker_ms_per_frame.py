"""Mean ms a call of the tracker step System makes (track_frame), one a frame, from a span with a
device synchronise at each end, over the window after the profiled slice."""

SPAN = ("tracker", "mcptam_tpu_torch.system.system", "track_frame")


def read(rec):
    d = rec.spans.get(SPAN[0])
    if not d:
        return None
    return 1e3 * sum(d) / len(d)
