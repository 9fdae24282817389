"""Host ms a frame of the program's ``tracker.track_frame`` span (the tracker
step as the host enqueues it) over the profiled slice."""

from harness.program_spans import per_unit

# the program's span this reads, after the step span that encloses it
PROGRAM_SPANS = ("system.batch_step", "tracker.track_frame")


def read(rec):
    return per_unit(rec, "frames", PROGRAM_SPANS[-1], "total_ms")
