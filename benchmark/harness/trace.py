"""The profiled slice: a few steps of the window under torch.profiler
(device activity only, spans off), reduced to what the per-layer metrics
and the breakdown read.  No trace file is written."""

from __future__ import annotations

import re
import time
from collections import defaultdict

N_BREAKDOWN = 10


def _kineto_device_events(prof) -> list:
    """(name, start_us, duration_us) of every device operation (kernel,
    copy, set) the profiler recorded."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type().name != "CUDA":
            continue
        if hasattr(ev, "start_ns"):
            start, dur = ev.start_ns() / 1e3, ev.duration_ns() / 1e3
        else:
            start, dur = float(ev.start_us()), float(ev.duration_us())
        out.append((ev.name(), start, dur))
    return out


def profile_slice(run, sync):
    """Run ``run()`` (it returns the units it completed, frames or LM
    iterations) under the profiler between two synchronises.  Returns
    (units, device events, host seconds of the slice, host seconds taken
    to stop the profiler and read its events, which the window leaves out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    # a build without CUDA (the CPU tests) records host activity, no device events
    act = ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU
    sync()
    with profile(activities=[act]) as prof:
        t0 = time.perf_counter()
        units = run()
        sync()
        wall = time.perf_counter() - t0
    events = _kineto_device_events(prof)
    return units, events, wall, time.perf_counter() - t0 - wall


def short_name(name: str) -> str:
    """A device operation's name without its return type and arguments."""
    name = name[5:] if name.startswith("void ") else name
    return name.split("(", 1)[0][:90] or name[:90]


def summarize(events: list, wall_s: float, units: int, unit: str, read_s: float = 0.0) -> dict:
    """Busy time as the union of the device intervals; the window the
    longer of the host's slice and the device's span, so busy never exceeds
    it; operations by name; idle gaps named by the operation that ended
    them (what the host was preparing)."""
    ev = sorted(events, key=lambda e: e[1])
    busy, gaps = 0.0, defaultdict(float)
    cur_s = cur_e = None
    for name, s, d in ev:
        e = s + d
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps[f"before {short_name(name)}"] += (s - cur_e) * 1e-6
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    span_s = (max(s + d for _, s, d in ev) - ev[0][1]) * 1e-6 if ev else 0.0
    window_s = max(wall_s, span_s)
    if ev:
        gaps["outside the device's first and last operation"] += window_s - span_s
    by_name, n_by_name = defaultdict(float), defaultdict(int)
    for name, _, d in ev:
        by_name[name] += d * 1e-6
        n_by_name[name] += 1
    by_short = defaultdict(float)
    for name, secs in by_name.items():
        by_short[short_name(name)] += secs
    top = sorted(by_short.items(), key=lambda kv: -kv[1])[:N_BREAKDOWN]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:N_BREAKDOWN]
    return {
        "unit": unit, "units": units, "n_ops": len(ev), "read_s": read_s,
        "busy_s": busy * 1e-6, "window_s": window_s, "kernel_s": dict(by_name),
        "kernel_n": dict(n_by_name),
        "breakdown": {"device_ops": [[k, v] for k, v in top],
                      "idle_gaps": [[k, v] for k, v in top_gaps]},
    }


def kernel_seconds(summary: dict, kernel: str) -> tuple:
    """Device seconds and executions of the kernel whose function name is
    ``kernel`` (its device name is that name, maybe after a return type or
    a namespace, followed by its arguments or template arguments)."""
    pat = re.compile(rf"(^|[\s:]){re.escape(kernel)}[(<]")
    names = [k for k in summary["kernel_s"] if pat.search(k)]
    return (sum(summary["kernel_s"][k] for k in names),
            sum(summary["kernel_n"][k] for k in names))
