"""Mean ms a call of the front-end call System makes (make_frame_features), one a frame, from a span with a
device synchronise at each end, over the window after the profiled slice."""

SPAN = ("features", "mcptam_tpu_torch.system.system", "make_frame_features")


def read(rec):
    d = rec.spans.get(SPAN[0])
    if not d:
        return None
    return 1e3 * sum(d) / len(d)
