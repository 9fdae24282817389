#!/usr/bin/env python3
"""The card smoke of the harness: run each cell (or the cells named) for a
few seconds with ``--trace 0`` and ``--trace 1``, each in a process of its
own as the benchmark's check runs it, and hold every result line against
BENCHMARK.json: exactly the metrics the manifest assigns to the cell and
the role, with their units; the device block's keys, busy above 0 and at
most the window in a traced run; ``correct`` true.

    python3 benchmark/smoke.py [--seconds 6] [--seed 1234567891] [cell ...]

Prints one line per run and exits non-zero if any run fails its check.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))

from harness.manifest import ROOT, load_manifest, printed_metrics  # noqa: E402

DEVICE_KEYS = ("platform", "kind", "count", "memory_peak_bytes")


def check_line(manifest: dict, cell: str, trace: bool, out: dict) -> list:
    """What is wrong with one result line, as a list of messages."""
    errs = []
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        if k not in out:
            errs.append(f"no key {k}")
    want = {m["name"]: m["unit"] for m in printed_metrics(manifest, cell, trace)}
    got = {k: v.get("unit") for k, v in out.get("metrics", {}).items()}
    if got != want:
        errs.append(f"metrics {sorted(got)} != manifest {sorted(want)} (units {got})")
    dev = out.get("device", {})
    keys = DEVICE_KEYS + (("busy_s", "window_s") if trace else ())
    errs += [f"device lacks {k}" for k in keys if k not in dev]
    if trace and "busy_s" in dev and not 0 < dev["busy_s"] <= dev.get("window_s", 0):
        errs.append(f"busy_s {dev['busy_s']} not in (0, window_s {dev.get('window_s')}]")
    if out.get("correct") is not True:
        errs.append("correct is not true")
    return errs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--seed", type=int, default=1234567891)
    ap.add_argument("cells", nargs="*")
    args = ap.parse_args()
    manifest = load_manifest()
    cells = args.cells or [w["name"] for w in manifest["workloads"]]
    bad = 0
    for cell in cells:
        for trace in (0, 1):
            cmd = [sys.executable, str(BENCH / "run.py"), "--workload", cell,
                   "--seed", str(args.seed + trace), "--seconds", str(args.seconds),
                   "--trace", str(trace)]
            t0 = time.perf_counter()
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, check=False)
            dt = time.perf_counter() - t0
            lines = p.stdout.strip().splitlines()
            try:
                out = json.loads(lines[-1]) if lines else {}
            except json.JSONDecodeError:
                out = {}
            errs = ([f"rc {p.returncode}"] if p.returncode else []) + check_line(
                manifest, cell, bool(trace), out)
            bad += bool(errs)
            print(f"smoke {cell} --trace {trace}: {'ok' if not errs else 'FAILED'} "
                  f"({dt:.1f} s) {'; '.join(errs)}")
            print(f"  line: {lines[-1] if lines else '(none)'}")
            if errs:
                print("  stderr tail:\n" + "\n".join(p.stderr.splitlines()[-40:]))
            sys.stdout.flush()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
