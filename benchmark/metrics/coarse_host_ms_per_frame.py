"""Host ms a frame of the tracker's ``tracker.coarse`` stage span (the coarse
search and its pose iterations) over the profiled slice."""

from harness.program_spans import per_unit


def read(rec):
    return per_unit(rec, "frames", "tracker.coarse", "total_ms")
