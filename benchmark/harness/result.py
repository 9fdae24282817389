"""The run's record, the metrics it yields and the result line."""

from __future__ import annotations

import dataclasses
import json
import sys

from harness.manifest import load_module, printed_metrics

@dataclasses.dataclass
class Record:
    unit: str = ""            # "frames" or "iters": what the window completes
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0            # frames returned / LM iterations landed in the window
    attempted: int = 0
    failed: int = 0
    latencies: list = dataclasses.field(default_factory=list)  # seconds per frame
    spans: dict = dataclasses.field(default_factory=dict)      # name -> [seconds]
    launches: dict = dataclasses.field(default_factory=dict)   # kernel -> [shape]
    counters: dict = dataclasses.field(default_factory=dict)   # the driver's counts by name
    slice: dict = None        # the profiled slice (harness/trace.py summarize)


def end_to_end_value(rec: Record, name: str):
    """The end-to-end metrics the benchmark takes itself: on the host's
    clock here, from the profiled slice's device trace by their reader
    ``metrics/<name>.py``."""
    if name == "setup_s":
        return rec.setup_s
    if name == "frames_per_s":
        return rec.units / rec.window_s if (
            rec.unit == "frames" and rec.window_s > 0 and rec.units > 0) else None
    return load_module("metrics", name).read(rec)


def assemble(manifest: dict, cell: str, rec: Record, trace: bool) -> tuple:
    """({name: {value, unit}}, [names of the cell's metrics that found
    nothing to read]).  A metric whose reader returns None is left out."""
    metrics, missing = {}, []
    e2e = {e["name"] for e in manifest["end_to_end"]}
    for m in printed_metrics(manifest, cell, trace):
        if m["name"] in e2e:
            v = end_to_end_value(rec, m["name"])
        else:
            v = load_module("metrics", m["name"]).read(rec)
        if v is None:
            missing.append(m["name"])
        else:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return metrics, missing


def device_block(kind: str, count: int, peak: int, rec: Record, trace: bool) -> dict:
    dev = {"platform": "gpu", "kind": kind, "count": count, "memory_peak_bytes": int(peak)}
    if trace and rec.slice is not None:
        dev["busy_s"] = rec.slice["busy_s"]
        dev["window_s"] = rec.slice["window_s"]
    return dev


def print_result(metrics: dict, device: dict, rec: Record, checks: dict, trace: bool):
    """The checks' last lines on standard error, then the result line, the
    checks under the key that comes last."""
    for name, (value, limit, ok) in checks.items():
        print(f"check {name}: {value} limit {limit} {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    out = {"correct": all(ok for _, _, ok in checks.values()),
           "attempted": rec.attempted, "failed": rec.failed,
           "metrics": metrics, "device": device}
    if trace and rec.slice is not None:
        out["breakdown"] = rec.slice["breakdown"]
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim, _) in checks.items()}
    print(json.dumps(out), flush=True)
