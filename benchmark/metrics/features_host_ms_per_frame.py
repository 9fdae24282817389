"""Host ms a frame of the program's ``frontend.features`` span (pyramid, FAST,
atlas, candidates, SBI as the host enqueues them) over the profiled slice."""

from harness.program_spans import per_unit


def read(rec):
    return per_unit(rec, "frames", "frontend.features", "total_ms")
