"""Host ms a frame of the tracker's ``tracker.fine`` stage span (the fine
search with subpixel refinement) over the profiled slice."""

from harness.program_spans import per_unit

# the program's span this reads, after the step span that encloses it
PROGRAM_SPANS = ("system.batch_step", "tracker.fine")


def read(rec):
    return per_unit(rec, "frames", PROGRAM_SPANS[-1], "total_ms")
