"""Host ms a frame the program waits in ``system.drain_wait`` for a drained
batch's scalars to land, over the profiled slice."""

from harness.program_spans import per_unit


def read(rec):
    return per_unit(rec, "frames", "system.drain_wait", "total_ms")
