"""Host ms an LM iteration of the ``ba.solve`` span (the ``spd_solve`` call,
K4) over the profiled slice."""

from harness.program_spans import per_unit


def read(rec):
    return per_unit(rec, "iters", "ba.solve", "total_ms")
