"""Host ms a frame of the tracker's ``tracker.pvs`` stage span (every point
projected into every camera) over the profiled slice."""

from harness.program_spans import per_unit


def read(rec):
    return per_unit(rec, "frames", "tracker.pvs", "total_ms")
