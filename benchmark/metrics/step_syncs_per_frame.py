"""Host synchronisations a frame inside the program's ``system.batch_step``
span over the profiled slice: what stands between the step and a CUDA graph."""

from harness.program_spans import per_unit


def read(rec):
    return per_unit(rec, "frames", "system.batch_step", "syncs")
