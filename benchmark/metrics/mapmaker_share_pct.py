"""100 x the host seconds of the program's map-maker ticks
(``mapmaker.tick:integrate``, ``:ba_chunk``, ``:idle`` spans of its
tracer) over the profiled slice's seconds, in a cell whose window
completes frames.  None where the slice holds no tick."""

from harness.program_spans import program_report

# the program's span this reads (every ``mapmaker.tick:<kind>``)
PROGRAM_SPANS = ("mapmaker.tick:integrate",)
TICK = PROGRAM_SPANS[0].split(":", 1)[0]


def read(rec):
    s = rec.slice
    if s is None or s["unit"] != "frames" or s["window_s"] <= 0:
        return None
    rep = program_report()
    if rep is None:
        return None
    ms = sum(d["total_ms"] for name, d in rep["spans"].items()
             if name.split(":", 1)[0] == TICK)
    return 100.0 * 1e-3 * ms / s["window_s"] if ms > 0 else None
