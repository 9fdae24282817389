"""What the program's own tracer (``mcptam_tpu_torch/system/timing.py``)
recorded over the profiled slice: the tracer records while a profiler
session does, so its spans cover the slice and nothing else of a run.
A program without the tracer, or whose tracer recorded no span of the
name, gives None."""

from __future__ import annotations


def program_report():
    """The tracer's ``report()``, or None where the program has no tracer."""
    try:
        from mcptam_tpu_torch.system import timing
    except ImportError:
        return None
    report = getattr(timing, "report", None)
    return report() if report is not None else None


def per_unit(rec, unit: str, span: str, field: str):
    """``field`` (``total_ms``, ``self_ms`` or ``syncs``) of the spans named
    ``span``, summed over the slice, per frame or LM iteration (``unit``)."""
    s = rec.slice
    if s is None or s["unit"] != unit or not s["units"]:
        return None
    rep = program_report()
    d = rep["spans"].get(span) if rep is not None else None
    if not d or not d["count"]:
        return None
    return d[field] / s["units"]
