"""Host ms an LM iteration of the program's ``ba.lm_step`` span over the
profiled slice."""

from harness.program_spans import per_unit


def read(rec):
    return per_unit(rec, "iters", "ba.lm_step", "total_ms")
