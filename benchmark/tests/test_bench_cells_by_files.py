"""A cell joins the benchmark by its files alone.

The tests take every cell and driver from the manifest and every size,
fault, span, launch and unit from the files the manifest names: a copy of
the benchmark with one more cell, brought by its files and entries only,
is collected by each of them, and the manifest's tests pass on it.  No
test file names a cell or a driver.  On the card, a traced run of each
cell at its small size prints every metric of the cell."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

import run
from harness import manifest as mf
from smoke import check_line

M = mf.load_manifest()
CELLS = [w["name"] for w in M["workloads"]]
DRIVERS = sorted({mf.load_json("traffic", w["traffic"])["driver"] for w in M["workloads"]})
# the tests and the files they take their trace and faults from
GENERIC = sorted((mf.BENCH_DIR / "tests").glob("*.py")) + [
    mf.BENCH_DIR / "conftest.py", mf.BENCH_DIR / "faults.py"]
FOUND_BY = ("test_bench_faults.py", "test_bench_program_spans.py", "test_bench_manifest.py",
            "test_bench_card.py")


@pytest.mark.parametrize("path", GENERIC, ids=lambda p: p.name)
def test_no_test_names_a_cell_or_a_driver(path):
    text = path.read_text()
    for cell in CELLS:
        assert cell not in text, (path.name, cell)
    for d in DRIVERS:
        pat = rf"""(["']){re.escape(d)}\1|drivers[./]{re.escape(d)}\b"""
        assert not re.search(pat, text), (path.name, d)


def drop_in_cell(root) -> str:
    """Copy the benchmark under ``root`` and add a cell to the copy by its
    files and entries: a mix naming the first cell's driver, its limits,
    its small size, and its entry in the manifest and in the workload
    lists of the first cell's metrics.  Returns the new cell's name."""
    copy = root / "benchmark"
    shutil.copytree(mf.BENCH_DIR, copy,
                    ignore=shutil.ignore_patterns("__pycache__", ".pytest_cache"))
    manifest = json.loads(json.dumps(M))
    base = manifest["workloads"][0]
    mix = base["traffic"] + "_dropped"
    cell = f"{base['config']}.{mix}"
    for kind, src, dst in (("traffic", base["traffic"], mix), ("limits", base["name"], cell),
                           ("small", base["name"], cell)):
        shutil.copy(copy / kind / f"{src}.json", copy / kind / f"{dst}.json")
    manifest["workloads"].append({**base, "name": cell, "traffic": mix})
    for role in mf.ROLES:
        for m in manifest[role]:
            if base["name"] in m.get("workloads", []):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest, indent=2))
    return cell


def test_a_cell_dropped_in_by_its_files_is_found(tmp_path):
    cell = drop_in_cell(tmp_path)
    tests = tmp_path / "benchmark" / "tests"
    env = {**os.environ, "PYTHONPATH": str(mf.ROOT)}

    def pytest_in_copy(*args):
        return subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                               *args], cwd=tests.parent, env=env, capture_output=True,
                              text=True, timeout=600)

    got = pytest_in_copy("--collect-only", str(tests))
    assert got.returncode == 0, got.stdout[-3000:] + got.stderr[-3000:]
    ids = got.stdout.splitlines()
    for name in FOUND_BY:
        assert any(name in i and cell in i for i in ids), (name, cell)
    got = pytest_in_copy(str(tests / "test_bench_manifest.py"), "-k", cell.rsplit(".", 1)[1])
    assert got.returncode == 0 and " passed" in got.stdout, got.stdout[-3000:]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_card_run_prints_every_metric(cell, card, small, capsys):
    rc = run.run_cell(cell, 2**31 + 2468, 3.0, True, overrides=small[cell])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert check_line(M, cell, True, out) == [], out
