#!/usr/bin/env python3
"""Where a benchmark cell's profiled slice leaves the card idle, by the
program's span that launched the work ending each gap:

    python3 scripts/idle_by_span.py --workload rig4_vga_m16.track --seed 1234567 --seconds 5

Runs the cell once as ``benchmark/run.py --trace 1`` does (its result line
is printed as the run prints it), keeps the profiler of the slice, and
prints after it one JSON line: the program's tracer report over the slice
(``mcptam_tpu_torch/system/timing.py`` ``report``), the host
synchronisations by source line (``sync_sites``), and each span's device
operations, device seconds and the idle seconds before the operations it
launched (``attribute_idle``), the largest idle first.  Needs a CUDA card,
as the benchmark does.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)

    import torch.profiler

    import run
    from mcptam_tpu_torch.system import timing

    kept = []

    class Keeping(torch.profiler.profile):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            kept.append(self)
            return out

    torch.profiler.profile = Keeping
    rc = run.run_cell(args.workload, args.seed, args.seconds, True)
    if rc or not kept:
        return rc or 1
    idle = timing.attribute_idle(kept[-1])
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "spans": timing.report(), "sync_sites": timing.sync_sites(),
        "idle_by_span": dict(sorted(idle.items(), key=lambda kv: -kv[1]["idle_s"])),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
