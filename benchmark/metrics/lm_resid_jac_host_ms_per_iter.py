"""Host ms an LM iteration of the ``ba.resid_jac`` span (residuals and
Jacobians) over the profiled slice."""

from harness.program_spans import per_unit


def read(rec):
    return per_unit(rec, "iters", "ba.resid_jac", "total_ms")
