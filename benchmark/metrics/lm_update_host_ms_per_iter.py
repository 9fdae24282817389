"""Host ms an LM iteration of the ``ba.update`` span (accept or reject) over
the profiled slice."""

from harness.program_spans import per_unit

# the program's span this reads, after the step span that encloses it
PROGRAM_SPANS = ("ba.lm_step", "ba.update")


def read(rec):
    return per_unit(rec, "iters", PROGRAM_SPANS[-1], "total_ms")
