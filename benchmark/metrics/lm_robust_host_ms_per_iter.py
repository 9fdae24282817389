"""Host ms an LM iteration of the ``ba.robust`` span (median, weights, cost)
over the profiled slice."""

from harness.program_spans import per_unit


def read(rec):
    return per_unit(rec, "iters", "ba.robust", "total_ms")
