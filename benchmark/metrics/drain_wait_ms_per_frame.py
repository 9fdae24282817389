"""Host ms a frame the program waits in ``system.drain_wait`` for a drained
batch's scalars to land, over the profiled slice."""

from harness.program_spans import per_unit

# the program's span this reads, after the step span that encloses it
PROGRAM_SPANS = ("system.batch_step", "system.drain_wait")


def read(rec):
    return per_unit(rec, "frames", PROGRAM_SPANS[-1], "total_ms")
