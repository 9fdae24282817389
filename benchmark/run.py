#!/usr/bin/env python3
"""Run one cell of the benchmark of ``mcptam_tpu_torch`` once, on the
CUDA device this process is started on:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (BENCHMARK.json ``workloads``) names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<traffic>.json``),
whose ``driver`` (``drivers/<driver>.py``) makes the inputs from the seed,
sets the program up, runs the measured window and judges the program's
outputs against the plain reference (``plainref/``) with the cell's limits
(``limits/<cell>.json``).  ``--trace 1`` profiles a slice of the window
and times the layers' spans over the rest; the metrics it prints are the
cell's per-layer metrics (``metrics/<metric>.py``) beside its end-to-end
ones.  The last line of standard output is the result, a JSON object;
the numbers compared, each beside its limit, are the last lines of
standard error and the result's last key.  Without a CUDA device, or with
fewer devices than the cell asks for, or with JAX loaded, it prints no
result and exits non-zero.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness.guard import forbidden_modules  # noqa: E402
from harness.manifest import (  # noqa: E402
    cell as find_cell, load_json, load_manifest, load_module, printed_metrics,
)
from harness.program_spans import clear_program_trace  # noqa: E402
from harness.result import Record, assemble, device_block, print_result  # noqa: E402
from harness.spans import Hooks  # noqa: E402


def install_hooks(hooks: Hooks, manifest: dict, cell: str):
    """The spans and launch records the cell's per-layer metrics read."""
    for m in printed_metrics(manifest, cell, trace=True):
        if any(e["name"] == m["name"] for e in manifest["end_to_end"]):
            continue
        mod = load_module("metrics", m["name"])
        if hasattr(mod, "SPAN"):
            name, module, attr = mod.SPAN
            hooks.span(module, attr, name)
        if hasattr(mod, "ROOFLINE"):
            rl = load_module("rooflines", mod.ROOFLINE)
            hooks.launch(*rl.HOOK, mod.ROOFLINE, rl.shape)


def merged(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device=None, overrides=None) -> int:
    """One run of a cell.  ``device`` and ``overrides`` ({"config": ...,
    "traffic": ..., "limits": ...}, merged into the cell's files) serve the
    CPU tests: they skip the look for a card and the kernel build."""
    import torch

    manifest = load_manifest()
    cell = find_cell(manifest, workload)
    if device is None and (not torch.cuda.is_available()
                           or torch.cuda.device_count() < cell["chips"]):
        print(f"run.py: cell {workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    over = overrides or {}
    cfg = merged(load_json("configs", cell["config"]), over.get("config", {}))
    mix = merged(load_json("traffic", cell["traffic"]), over.get("traffic", {}))
    limits = merged(load_json("limits", workload), over.get("limits", {}))
    driver = importlib.import_module(f"drivers.{mix['driver']}")
    if device is None:
        dev, sync = torch.device("cuda:0"), torch.cuda.synchronize
        torch.cuda.set_device(dev)
        from mcptam_tpu_torch.csrc._build import build, load
        build()
        load()
    else:
        dev, sync = torch.device(device), (lambda: None)
    hooks = Hooks(sync)
    install_hooks(hooks, manifest, workload)
    rec = Record(unit=driver.UNIT)
    try:
        sess = driver.setup(cfg, mix, seed, dev, sync)
        sync()
        rec.setup_s = time.perf_counter() - T0
        clear_program_trace()
        driver.window(sess, seconds, rec, hooks, trace)
        if rec.slice is not None:
            print(f"run.py: profiled slice of {rec.slice['units']} {rec.unit}: "
                  f"{rec.slice['n_ops']} device operations, {rec.slice['window_s']:.3f} s, "
                  f"{rec.slice['read_s']:.3f} s to read the trace", file=sys.stderr)
        rec.spans, rec.launches = dict(hooks.spans), dict(hooks.launches)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    finally:
        hooks.restore()
    driver.release(sess)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = driver.judge(sess, limits)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: JAX or the JAX package is loaded: {bad}", file=sys.stderr)
        return 3
    metrics, missing = assemble(manifest, workload, rec, trace)
    for name in missing:
        print(f"run.py: metric {name} of cell {workload} found nothing to read in this "
              "run and is left out of the result", file=sys.stderr)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print_result(metrics, device_block(kind, cell["chips"], peak, rec, trace), rec,
                 checks, trace)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    return run_cell(args.workload, args.seed, args.seconds, bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
