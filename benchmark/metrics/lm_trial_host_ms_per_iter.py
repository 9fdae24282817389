"""Host ms an LM iteration of the ``ba.trial`` span (the updated estimate's
residuals and cost) over the profiled slice."""

from harness.program_spans import per_unit


def read(rec):
    return per_unit(rec, "iters", "ba.trial", "total_ms")
