"""Host ms a frame of the tracker's ``tracker.pose`` stage span (the Tukey
WLS pose solve and its covariance) over the profiled slice."""

from harness.program_spans import per_unit


def read(rec):
    return per_unit(rec, "frames", "tracker.pose", "total_ms")
