"""Host ms a frame of the program's ``frontend.features`` span (pyramid, FAST,
atlas, candidates, SBI as the host enqueues them) over the profiled slice."""

from harness.program_spans import per_unit

# the program's span this reads, after the step span that encloses it
PROGRAM_SPANS = ("system.batch_step", "frontend.features")


def read(rec):
    return per_unit(rec, "frames", PROGRAM_SPANS[-1], "total_ms")
