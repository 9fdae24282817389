"""Host ms an LM iteration of the ``ba.update`` span (accept or reject) over
the profiled slice."""

from harness.program_spans import per_unit


def read(rec):
    return per_unit(rec, "iters", "ba.update", "total_ms")
