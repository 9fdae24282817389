"""BENCHMARK.json against the files it names, and the metric assembly of
every cell in both roles, fed recorded spans, counters and device events."""

import importlib
import json
import re

import pytest

from harness import manifest as mf
from harness.result import Record, assemble, device_block
from harness.trace import summarize

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = mf.load_manifest()
CELLS = [w["name"] for w in M["workloads"]]


def test_names_units_and_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    names = [c["name"] for c in M["configs"]] + CELLS + [
        m["name"] for r in mf.ROLES for m in M[r]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in M["workloads"]]:
        assert NAME.match(n), n
    for role in mf.ROLES:
        for m in M[role]:
            assert UNIT.match(m["unit"]), m
            assert m["better"] in ("lower", "higher")
            assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves",
                              "workloads"}
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in M["end_to_end"]}
    for m in M["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for w in m.get("workloads", []):
            assert w in CELLS and m["moves"] in {
                e["name"] for e in mf.cell_metrics(M, w, "end_to_end")}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    w = mf.cell(M, cell)
    cfg = mf.load_json("configs", w["config"])
    mix = mf.load_json("traffic", w["traffic"])
    mf.load_json("limits", cell)
    mf.load_json("small", cell)
    assert (mf.BENCH_DIR / "drivers" / f"{mix['driver']}.py").is_file()
    entry = next(c for c in M["configs"] if c["name"] == w["config"])
    assert entry["file"] == f"benchmark/configs/{w['config']}.json"
    assert entry["reduced"] == cfg["reduced"]
    assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in mf.printed_metrics(M, cell, trace=True):
        if m["name"] not in {e["name"] for e in M["end_to_end"]}:
            assert hasattr(mf.load_module("metrics", m["name"]), "read")


def driver_of(cell: str):
    """The module of the cell's driver (its mix's ``driver``)."""
    mix = mf.load_json("traffic", mf.cell(M, cell)["traffic"])
    return importlib.import_module(f"drivers.{mix['driver']}")


def metric_modules(cell: str) -> list:
    """The readers of the cell's per-layer metrics."""
    return [mf.load_module("metrics", m["name"]) for m in mf.cell_metrics(M, cell, "per_layer")]


def _events(kernels) -> list:
    """Device events of a slice: one execution of each kernel (by its
    roofline file's ``KERNEL``) beside eager operators."""
    ev = [("void at::native::add_kernel<float>(int)", 0.0, 20.0)]
    ev += [(f"void (anonymous namespace)::{k}<float>(float const*, int)", 10.0 + 40.0 * i, 30.0)
           for i, k in enumerate(kernels)]
    t = 100.0 + 40.0 * len(kernels)
    return ev + [("Memcpy DtoH (Device -> Pinned)", t, 5.0),
                 ("void at::native::add_kernel<float>(int)", t + 300.0, 10.0)]


def recorded(cell: str) -> Record:
    """A fixed Record of a cell's run: what its metrics declare they read
    (a hook's ``SPAN``, a ``ROOFLINE``'s example launch and its kernel's
    execution, a driver's ``COUNTER``) and a profiled slice."""
    unit = driver_of(cell).UNIT
    rec = Record(unit=unit, setup_s=12.5, window_s=10.0, units=60, attempted=64)
    rec.latencies = [0.1 + 0.01 * i for i in range(40)]
    kernels = []
    for mod in metric_modules(cell):
        if hasattr(mod, "SPAN"):
            rec.spans[mod.SPAN[0]] = [0.005] * 8
        if hasattr(mod, "COUNTER"):
            rec.counters[mod.COUNTER] = 3
        if hasattr(mod, "ROOFLINE") and mod.ROOFLINE not in rec.launches:
            rl = mf.load_module("rooflines", mod.ROOFLINE)
            rec.launches[mod.ROOFLINE] = [rl.EXAMPLE]
            kernels.append(rl.KERNEL)
    rec.slice = summarize(_events(kernels), 0.002, 8, unit)
    return rec


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_assembly_yields_exactly_the_manifest(cell, trace):
    metrics, missing = assemble(M, cell, recorded(cell), trace)
    want = {m["name"]: m["unit"] for m in mf.printed_metrics(M, cell, trace)}
    assert missing == []
    assert {k: v["unit"] for k, v in metrics.items()} == want
    assert all(isinstance(v["value"], float) for v in metrics.values())
    json.dumps(metrics)


@pytest.mark.parametrize("cell", CELLS)
def test_a_reader_with_nothing_to_read_leaves_its_metric_out(cell):
    rec = Record(unit=driver_of(cell).UNIT, setup_s=1.0)
    metrics, missing = assemble(M, cell, rec, trace=True)
    assert list(metrics) == ["setup_s"]
    assert "setup_s" not in missing and missing


def test_device_block_and_busy_within_window():
    rec = recorded(CELLS[0])
    dev = device_block("NVIDIA H100 80GB HBM3", 1, 123, rec, True)
    assert set(dev) == {"platform", "kind", "count", "memory_peak_bytes", "busy_s", "window_s"}
    assert 0 < dev["busy_s"] <= dev["window_s"]
    # busy is the union: overlapping intervals count once, gaps not at all
    s = summarize([("a", 0.0, 10.0), ("b", 5.0, 10.0), ("c", 30.0, 5.0)], 0.0, 1, "frames")
    assert s["busy_s"] == pytest.approx(20e-6) and s["window_s"] == pytest.approx(35e-6)
    assert s["breakdown"]["idle_gaps"][0] == ["before c", pytest.approx(15e-6)]
    assert set(device_block("cpu", 1, 0, rec, False)) == {
        "platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("kernel", sorted(p.stem for p in (mf.BENCH_DIR / "rooflines").glob("*.py")))
def test_roofline_pairs_launches_with_executions(kernel):
    from harness.roofline import share_pct
    rl = mf.load_module("rooflines", kernel)
    rec = Record(unit="frames")
    rec.launches = {kernel: [rl.EXAMPLE]}
    rec.slice = summarize(_events([rl.KERNEL]), 0.002, 8, "frames")
    got = share_pct(rec, kernel)
    assert 0 < got < 100
    rec.launches[kernel].append(rl.EXAMPLE)
    assert share_pct(rec, kernel) is None                  # two launches, one execution


@pytest.mark.parametrize("kind,name,text", [
    ("configs", "new_cfg", '{"rig": {}}'),
    ("traffic", "new_mix", '{"driver": "any"}'),
    ("metrics", "new_metric", "def read(rec):\n    return 7.0\n"),
    ("rooflines", "new_kernel.v2", "KERNEL = 'k'\ndef count(c):\n    return 1, 2\n"),
])
def test_a_file_dropped_in_its_folder_is_found_by_name(tmp_path, monkeypatch, kind, name, text):
    (tmp_path / kind).mkdir()
    ext = ".py" if kind in ("metrics", "rooflines") else ".json"
    (tmp_path / kind / f"{name}{ext}").write_text(text)
    monkeypatch.setattr(mf, "BENCH_DIR", tmp_path)
    if ext == ".json":
        assert mf.load_json(kind, name) == json.loads(text)
    else:
        mod = mf.load_module(kind, name)
        assert (mod.read(None) == 7.0) if kind == "metrics" else mod.count(None) == (1, 2)
    with pytest.raises(FileNotFoundError):
        mf.load_json(kind, "absent")


def test_smoke_checker_names_a_missing_metric():
    from smoke import check_line
    cell = CELLS[0]
    rec = recorded(cell)
    metrics, _ = assemble(M, cell, rec, True)
    line = {"correct": True, "attempted": 1, "failed": 0, "metrics": metrics,
            "device": device_block("k", 1, 1, rec, True)}
    assert check_line(M, cell, True, line) == []
    del line["metrics"][next(iter(metrics))]
    assert any("manifest" in e for e in check_line(M, cell, True, line))
