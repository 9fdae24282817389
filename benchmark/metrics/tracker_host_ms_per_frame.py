"""Host ms a frame of the program's ``tracker.track_frame`` span (the tracker
step as the host enqueues it) over the profiled slice."""

from harness.program_spans import per_unit


def read(rec):
    return per_unit(rec, "frames", "tracker.track_frame", "total_ms")
