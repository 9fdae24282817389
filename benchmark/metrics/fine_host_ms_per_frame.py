"""Host ms a frame of the tracker's ``tracker.fine`` stage span (the fine
search with subpixel refinement) over the profiled slice."""

from harness.program_spans import per_unit


def read(rec):
    return per_unit(rec, "frames", "tracker.fine", "total_ms")
