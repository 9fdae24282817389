#!/usr/bin/env python3
"""Readings for the limits of a cell's comparison, in one process on the
card: for each seed, the numbers the judge compares for the program (a
short window at the cell's own load, long enough to finish what the
judge samples), and with ``--control`` for the precision control too:
the plain reference put in the program's place and computed with TF32
(the configuration states float32 with TF32 off), judged by the same
judge against the reference in float32.  ``--faults`` reads the program
with each named fault of the cell's driver (``FAULTS`` in
``drivers/<driver>.py``, planted by ``faults.py``) under its timed path:
the readings that set the upper end of a number that the control does not
separate.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 [--program] [--control]
        [--faults state_unchanged half_batch answer_altered]

Prints one JSON line per seed and side; the benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from faults import plant  # noqa: E402
from harness.manifest import cell as find_cell, load_json, load_manifest  # noqa: E402
from harness.result import Record  # noqa: E402
from harness.spans import Hooks  # noqa: E402


class NoLimits(dict):
    """Every number the judge knows, none of them limited."""

    def __contains__(self, key):
        return True

    def __missing__(self, key):
        return float("inf")


NO_LIMITS = NoLimits()


def read_seeds(workload: str, seeds, sides, dev, calls: int = 0, overrides=None, limits=None):
    """Yield one dict of readings per seed and side ("program", "control",
    or the name of a fault).  With ``limits`` it also holds under
    ``failed`` the names of the numbers that fail them, as the judge
    decides (an upper limit or a floor)."""
    import torch

    from run import merged

    over = overrides or {}
    cell = find_cell(load_manifest(), workload)
    cfg = merged(load_json("configs", cell["config"]), over.get("config", {}))
    mix = merged(load_json("traffic", cell["traffic"]), over.get("traffic", {}))
    driver = importlib.import_module(f"drivers.{mix['driver']}")
    sync = torch.cuda.synchronize
    calls = calls or driver.CONTROL_CALLS(mix)
    for seed in seeds:
        for side in sides:
            t0 = time.perf_counter()
            make = driver.control_setup if side == "control" else driver.setup
            restore = (lambda: None) if side in ("program", "control") else \
                plant(mix["driver"], side)
            try:
                sess = make(cfg, mix, seed, dev, sync)
                rec = Record(unit=driver.UNIT)
                driver.window(sess, 1e9, rec, Hooks(sess.sync), False, calls)
                driver.release(sess)
            finally:
                restore()
            checks = driver.judge(sess, NO_LIMITS if limits is None else limits)
            got = {k: v for k, (v, _, _) in checks.items()}
            if limits is not None:
                got["failed"] = sorted(k for k, (_, _, ok) in checks.items() if not ok)
            torch.cuda.empty_cache()
            yield {"workload": workload, "side": side, "seed": seed,
                   "seconds": round(time.perf_counter() - t0, 1), **got}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--calls", type=int, default=0,
                    help="window calls (batches or chunks); 0: the driver's own")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    from mcptam_tpu_torch.csrc._build import build, load
    build()
    load()
    sides = ([k for k in ("program", "control") if getattr(args, k)]) + args.faults
    for got in read_seeds(args.workload, args.seeds, sides, torch.device("cuda:0"), args.calls):
        print(json.dumps(got), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
