"""Host ms an LM iteration of the ``ba.schur`` span's self time (the reduced
system's assembly and the Schur reduction, less its ``ba.resid_jac`` and
``ba.solve``) over the profiled slice."""

from harness.program_spans import per_unit

# the program's span this reads, after the step span that encloses it
PROGRAM_SPANS = ("ba.lm_step", "ba.schur")


def read(rec):
    return per_unit(rec, "iters", PROGRAM_SPANS[-1], "self_ms")
