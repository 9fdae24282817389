"""The per-layer metrics read from the program's own tracer
(``harness/program_spans.py``, ``mcptam_tpu_torch/system/timing.py``).

On the CPU: each cell at a small size with ``--trace 1`` prints every one
of them.  On the card: the host-synchronisation counter counts a planted
``.item()``, a ``pinv`` and an ``Event.synchronize()``; every kernel
launched inside a span starts on the device no earlier than the span
started on the host (one clock for both); and the spans add no device
operation to a profiled trace."""

import json

import pytest
import torch

import run
from harness import manifest as mf

M = mf.load_manifest()
CELLS = [w["name"] for w in M["workloads"]]


def program_span_metrics(cell: str) -> list:
    return [m["name"] for m in mf.cell_metrics(M, cell, "per_layer")
            if "per_unit" in (mf.BENCH_DIR / "metrics" / f"{m['name']}.py").read_text()]


def test_every_program_span_metric_has_a_cell():
    assert sum(len(program_span_metrics(c)) for c in CELLS) == 18


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_prints_every_program_span_metric(cell, small, capsys):
    from mcptam_tpu_torch.system import timing

    timing.clear()
    torch.manual_seed(0)
    rc = run.run_cell(cell, 2**31 + 4321, 2.0, True, device="cpu", overrides=small[cell])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["correct"], out["checks"]
    want = program_span_metrics(cell)
    assert want and set(want) <= set(out["metrics"]), sorted(set(want) - set(out["metrics"]))
    for name in want:
        v = out["metrics"][name]["value"]
        assert v >= 0 and (v > 0 or "syncs" in name), (name, v)


def _launches_and_ops(prof):
    """({correlation id: host ns of the launch}, [(device start ns, correlation id)])."""
    from mcptam_tpu_torch.system.timing import _is_launch

    launch, ops = {}, []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type().name == "CUDA":
            ops.append((ev.start_ns(), ev.correlation_id()))
        elif _is_launch(ev):
            launch[ev.correlation_id()] = ev.start_ns()
    return launch, ops


@pytest.mark.card
def test_host_syncs_are_counted(card):
    from mcptam_tpu_torch.system import timing

    x = torch.randn(6, 6, device=card)
    H = x @ x.T + torch.eye(6, device=card)
    torch.cuda.synchronize()
    timing.clear()
    prev = timing.enable(True)
    try:
        with timing.span("item"):
            x[0, 0].item()
        with timing.span("pinv"):
            torch.linalg.pinv(H)
        with timing.span("event"):
            ev = torch.cuda.Event()
            ev.record()
            timing.wait(ev)
        with timing.span("none"):
            (H @ H).sum()
    finally:
        timing.enable(*prev)
    syncs = {r.name: r.syncs for r in timing.records()}
    assert syncs["item"] == 1 and syncs["event"] == 1 and syncs["none"] == 0, syncs
    assert syncs["pinv"] >= 1, syncs
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.card
def test_kernels_start_after_their_span_on_one_clock(card):
    from torch.profiler import ProfilerActivity, profile

    from mcptam_tpu_torch.system import timing

    x = torch.randn(512, 512, device=card)
    torch.cuda.synchronize()
    timing.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(20):
            with timing.span("outer", i):
                y = x @ x
                with timing.span("inner"):
                    y = torch.relu(y) + 1.0
        torch.cuda.synchronize()
    recs = timing.records()
    launch, ops = _launches_and_ops(prof)
    assert len(recs) == 40 and len(ops) >= 60
    for start, corr in ops:
        t = launch[corr]
        inside = [r for r in recs if r.start_ns <= t <= r.end_ns]
        assert inside, (t, corr)
        assert start >= max(r.start_ns for r in inside)
    got = timing.attribute_idle(prof, recs)
    assert sum(v["ops"] for v in got.values()) == len(ops) and "(no span)" not in got


@pytest.mark.card
def test_spans_add_no_device_operation(card, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    from mcptam_tpu_torch.system import timing

    x = torch.randn(256, 256, device=card)

    def work():
        with timing.span("outer", 0):
            for _ in range(10):
                with timing.span("inner"):
                    (x @ x).relu_()

    counts = []
    for traced in (True, False):
        if not traced:
            monkeypatch.setattr(timing, "_profiling", lambda: False)
        torch.cuda.synchronize()
        timing.clear()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            work()
            torch.cuda.synchronize()
        evs = list(prof.profiler.kineto_results.events())
        counts.append(sum(e.device_type().name == "CUDA" for e in evs))
        assert not any(e.is_user_annotation() for e in evs)
        assert len(timing.records()) == (11 if traced else 0)
    assert counts[0] == counts[1] > 0
