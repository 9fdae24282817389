"""Host synchronisations an LM iteration inside the program's ``ba.lm_step``
span over the profiled slice."""

from harness.program_spans import per_unit

# the program's span this reads, after the step span that encloses it
PROGRAM_SPANS = ("ba.lm_step",)


def read(rec):
    return per_unit(rec, "iters", PROGRAM_SPANS[-1], "syncs")
