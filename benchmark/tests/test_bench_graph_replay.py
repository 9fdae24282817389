"""``tracker_graph_replay_pct``: the share of the profiled slice's frames
whose tracker step replayed its CUDA graphs (``tracker.graph_replay``
spans of the program's tracer over the slice's frames).

On the CPU, from a planted trace; on the card, a traced run at a small
size of each cell whose map the map-maker never changes reads 100."""

import json

import pytest

import run
from harness import manifest as mf
from harness.manifest import load_module
from harness.result import Record

METRIC = "tracker_graph_replay_pct"
M = mf.load_manifest()
# the cells that report the metric on a map the map-maker never changes
# (their mix ticks it never), so that every frame after the warm-up replays
STILL_MAP_CELLS = [w["name"] for w in M["workloads"]
                   if METRIC in {m["name"] for m in mf.cell_metrics(M, w["name"], "per_layer")}
                   and not mf.load_json("traffic", w["traffic"]).get("tick_every", 0)]


@pytest.fixture
def tracer():
    from mcptam_tpu_torch.system import timing

    prev = timing.enable(True)
    timing.clear()
    yield timing
    timing.enable(*prev)
    timing.clear()


def frames_slice(units: int) -> Record:
    rec = Record(unit="frames")
    rec.slice = {"unit": "frames", "units": units}
    return rec


@pytest.mark.parametrize("replays,units,want", [(8, 8, 100.0), (3, 8, 37.5), (0, 8, 0.0)])
def test_reads_replays_over_frames(tracer, replays, units, want):
    for i in range(units):
        with tracer.span("tracker.track_frame", i):
            if i < replays:
                with tracer.span("tracker.graph_replay"):
                    pass
    assert load_module("metrics", METRIC).read(frames_slice(units)) == want


def test_nothing_to_read_without_a_frames_slice(tracer):
    read = load_module("metrics", METRIC).read
    assert read(Record(unit="frames")) is None
    assert read(frames_slice(0)) is None
    rec = Record(unit="iters")
    rec.slice = {"unit": "iters", "units": 16}
    assert read(rec) is None


@pytest.mark.card
@pytest.mark.parametrize("cell", STILL_MAP_CELLS)
def test_a_traced_card_run_replays_every_frame(cell, card, small, capsys):
    rc = run.run_cell(cell, 2**31 + 4321, 2.0, True, overrides=small[cell])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["correct"], out["checks"]
    assert out["metrics"][METRIC]["value"] == 100.0
    if "step_syncs_per_frame" in out["metrics"]:
        assert out["metrics"]["step_syncs_per_frame"]["value"] == 0.0
