"""Host ms a frame of the tracker's ``tracker.finalize`` stage span (scene
depth, quality, state update) over the profiled slice."""

from harness.program_spans import per_unit


def read(rec):
    return per_unit(rec, "frames", "tracker.finalize", "total_ms")
