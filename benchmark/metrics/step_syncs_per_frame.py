"""Host synchronisations a frame inside the program's ``system.batch_step``
span over the profiled slice: what stands between the step and a CUDA graph."""

from harness.program_spans import per_unit

# the program's span this reads, after the step span that encloses it
PROGRAM_SPANS = ("system.batch_step",)


def read(rec):
    return per_unit(rec, "frames", PROGRAM_SPANS[-1], "syncs")
