"""Host ms a frame of the tracker's ``tracker.sbi`` stage span (the SBI ESM
rotation) over the profiled slice."""

from harness.program_spans import per_unit


def read(rec):
    return per_unit(rec, "frames", "tracker.sbi", "total_ms")
