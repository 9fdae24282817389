"""BENCHMARK.json and the files of the benchmark that it names.

Everything that belongs to one configuration, traffic mix, per-layer
metric or kernel roofline count is a file of its own, found by its name:

    configs/<config>.json       the deployment's sizes and settings
    traffic/<traffic>.json      the mix: its driver and its parameters
    drivers/<driver>.py         the general generator and loop of a kind of mix
    metrics/<metric>.py         read(rec) -> value or None
    rooflines/<kernel>.py       KERNEL (device name prefix), count(call) -> (bytes, ops)
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
ROLES = ("end_to_end", "per_layer")


def load_manifest(path: Path | None = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in manifest['workloads']]}")


def cell_metrics(manifest: dict, name: str, role: str) -> list:
    """The metrics of ``role`` that cell ``name`` reports: those whose
    ``workloads`` list names it, or that have no such list."""
    return [m for m in manifest[role] if name in m.get("workloads", [name])]


def printed_metrics(manifest: dict, name: str, trace: bool) -> list:
    """The metrics a run of cell ``name`` prints: the end-to-end ones, and
    with ``trace`` every per-layer one too."""
    out = cell_metrics(manifest, name, "end_to_end")
    if trace:
        out += cell_metrics(manifest, name, "per_layer")
    return out


def load_json(kind: str, name: str) -> dict:
    path = BENCH_DIR / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """The module ``<kind>/<name>.py``, loaded by path (a name may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
