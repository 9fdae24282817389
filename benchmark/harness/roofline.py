"""A kernel's share of its roofline in the profiled slice: the least time
its launches could take on the card (rooflines/<kernel>.py counts each
launch's bytes and operations from its shapes) over the device time the
trace gives the kernel by name."""

from __future__ import annotations

from harness.manifest import load_module
from harness.peaks import least_seconds
from harness.trace import kernel_seconds


def share_pct(rec, kernel: str):
    """None where the slice launched the kernel never, or its launches and
    executions do not pair up one to one."""
    mod = load_module("rooflines", kernel)
    calls = [c for c in rec.launches.get(kernel, []) if c is not None]
    if rec.slice is None or not calls:
        return None
    secs, n = kernel_seconds(rec.slice, mod.KERNEL)
    if n != len(calls) or secs <= 0.0:
        return None
    least = sum(least_seconds(*mod.count(c)) for c in calls)
    return 100.0 * least / secs
