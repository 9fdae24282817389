"""Host ms an LM iteration of the ``ba.schur`` span's self time (the reduced
system's assembly and the Schur reduction, less its ``ba.resid_jac`` and
``ba.solve``) over the profiled slice."""

from harness.program_spans import per_unit


def read(rec):
    return per_unit(rec, "iters", "ba.schur", "self_ms")
