"""The port's tracer (system/timing.py): spans on the frame path and the
LM path, their ids, nesting and self times, the host-synchronisation
counter, TrackerTiming filled from the spans, the join of device
operations to spans (``attribute_idle``), and the module-global names the
benchmark patches, which must still intercept the calls.

The System runs on a 2-camera 240x320 ground-truth map on the CPU; the
tracer is switched on either by a torch.profiler session (host activity)
or by ``timing.enable(True)``."""

import dataclasses
from collections import deque
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mcptam_tpu_torch.ba import bundle
from mcptam_tpu_torch.ba.problems import build
from mcptam_tpu_torch.config import MapMakerConfig, TrackerConfig
from mcptam_tpu_torch.core.se3 import SE3
from mcptam_tpu_torch.io.synthetic import (
    build_groundtruth_map, make_rig, make_sbi_cams, render_rig,
)
from mcptam_tpu_torch.map.state import clone_tree
from mcptam_tpu_torch.ops import batch_patch
from mcptam_tpu_torch.system import system as system_mod
from mcptam_tpu_torch.system import timing
from mcptam_tpu_torch.system.system import System

H, W, C = 240, 320, 2
SEED = 3.0
STAGES = ("tracker.sbi", "tracker.motion", "tracker.pvs", "tracker.coarse",
          "tracker.fine", "tracker.pose", "tracker.finalize")
FRAME_SPANS = ("frontend.features", "tracker.track_frame", "system.frame_tail") + STAGES
LM_SPANS = ("ba.lm_step", "ba.robust", "ba.schur", "ba.resid_jac", "ba.solve",
            "ba.trial", "ba.update")
TIMED = ("kf_downsample", "kf_feature", "sbi", "motion", "pvs", "coarse", "fine", "pose",
         "depth", "add")


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the tracer off and its ring empty."""
    prev = timing.enable(False)
    timing.clear()
    yield
    timing.enable(*prev)
    timing.clear()


@pytest.fixture(scope="module")
def scene():
    cams, cfb = make_rig(C, H, W, spread_deg=25.0, device="cpu")
    ms, _ = build_groundtruth_map(cams, cfb, H, W, seed=SEED, n_per_level=12,
                                  max_points=1024, max_mkfs=8, max_meas=4096)

    def tangent(i):
        return torch.tensor([0.01 * i, 0, 0.005 * i, 0, 0.01 * i, 0], dtype=torch.float32)

    frames = torch.stack([
        torch.clamp(render_rig(cams, cfb, SE3.exp(tangent(i)), SEED, H, W), 0, 255)
        .to(torch.uint8) for i in range(4)])
    return cams, cfb, ms, frames


def make_system(scene, depth=2):
    cams, cfb, ms, _ = scene
    sys_ = System(cams, cfb, make_sbi_cams(cams, H, W), H, W, TrackerConfig(),
                  MapMakerConfig(), 1024, 8, 4096, pipeline_depth=depth)
    sys_.ms, sys_.initialized = clone_tree(ms), True
    sys_.vars["AddingMKFs"] = False
    sys_.tick_every = 1 << 30
    return sys_


class traced:
    """The tracer on, by a profiler session or by enable(True)."""

    def __init__(self, how):
        self.how = how

    def __enter__(self):
        if self.how == "profiler":
            self.prof = profile(activities=[ProfilerActivity.CPU])
            self.prof.__enter__()
        else:
            self.prev = timing.enable(True)

    def __exit__(self, *exc):
        if self.how == "profiler":
            self.prof.__exit__(*exc)
        else:
            timing.enable(*self.prev)


def run_frames(sys_, frames, path):
    """Every frame through ``path``, then the pipeline flushed; the
    FrameInfos of the drained frames, each once."""
    if path == "batch":
        infos = sys_.process_frames(frames[:2]) + sys_.process_frames(frames[2:])
    else:
        infos = [i for f in frames for i in [sys_.process_frame(f)] if not i.provisional]
    return infos + sys_.flush_pipeline()


def check_self_times(recs):
    """A record's self time is its duration less its children's."""
    child = {}
    for r in recs:
        child[r.parent] = child.get(r.parent, 0) + (r.end_ns - r.start_ns)
    for r in recs:
        assert r.self_ns == r.end_ns - r.start_ns - child.get(r.seq, 0), r
        assert 0 <= r.self_ns <= r.end_ns - r.start_ns


def test_off_by_default_records_nothing(scene):
    sys_ = make_system(scene)
    infos = run_frames(sys_, scene[3], "batch")
    assert [i.frame_id for i in infos] == [0, 1, 2, 3]
    assert timing.records() == [] and timing.report() == {"spans": {}, "dropped": 0}
    for i in infos:
        assert all(getattr(i.timing, f) == 0.0 for f in TIMED + ("total",)), i.timing
        assert i.timing.map_num_points == i.n_points > 0


@pytest.mark.parametrize("path", ["batch", "frame"])
@pytest.mark.parametrize("how", ["profiler", "enable"])
def test_frame_spans_nested_with_frame_ids(scene, how, path):
    """Each frame's taxonomy spans, nested under the step span with the
    frame's id; TrackerTiming from them, its total the sum of its fields."""
    sys_ = make_system(scene)
    with traced(how):
        infos = run_frames(sys_, scene[3], path)
    recs = timing.records()
    by_seq = {r.seq: r for r in recs}
    step = "system.batch_step" if path == "batch" else "system.device_step"
    for fid in range(4):
        mine = [r for r in recs if r.id == fid and r.name in FRAME_SPANS]
        assert sorted(r.name for r in mine) == sorted(FRAME_SPANS), fid
        for r in mine:
            up = by_seq[r.parent]
            if r.name in STAGES:
                assert up.name == "tracker.track_frame" and up.id == fid
            else:
                assert up.name == step
            assert up.start_ns <= r.start_ns <= r.end_ns <= up.end_ns
    # batch: the first batch drained by the second call, the second by the
    # flush; frame: two provisional drains while priming, then four
    n_drains = 2 if path == "batch" else 6
    assert len([r for r in recs if r.name == "system.drain_wait"]) == n_drains
    check_self_times(recs)
    rep = timing.report()
    assert rep["dropped"] == 0
    assert rep["spans"]["tracker.track_frame"]["count"] == 4
    assert [i.frame_id for i in infos] == [0, 1, 2, 3]
    for i in infos:
        t = i.timing
        assert all(getattr(t, f) > 0 for f in TIMED if f != "kf_feature"), t
        assert t.total == pytest.approx(sum(getattr(t, f) for f in TIMED))
        spans = {r.name: (r.end_ns - r.start_ns) * 1e-9 for r in recs if r.id == i.frame_id}
        assert t.coarse == spans["tracker.coarse"] and t.depth == spans["tracker.finalize"]
        assert t.kf_downsample == spans["frontend.features"]
        assert t.add == spans["system.frame_tail"]


def test_profile_frame_reads_its_spans(scene):
    """profile_frame: one device step under the synchronous mode, its
    TrackerTiming the frame's spans, and the tracer's state restored."""
    sys_ = make_system(scene)
    t = sys_.profile_frame(scene[3][0])
    assert timing.enable(False) == (False, False)
    recs = timing.records()
    assert {r.name for r in recs} == set(FRAME_SPANS) | {"system.device_step"}
    assert all(r.id == 0 for r in recs)
    assert all(getattr(t, f) > 0 for f in TIMED if f != "kf_feature")
    assert t.total == pytest.approx(sum(getattr(t, f) for f in TIMED))
    assert sys_.frame_count == 1


@pytest.mark.parametrize("table", [True, False], ids=["soa", "scatter"])
def test_lm_spans(table):
    """Every LM iteration's spans on the SoA path (observation table) and
    on the scatter path, each iteration's under a ``ba.lm_step`` of its
    own id."""
    prob, cams = build(4, 64, 2, H=120, W=160, sparse_k=512, device="cpu")
    if table:
        prob = bundle.attach_obs_table(prob, 16)
    st = bundle.create_lm_state(prob)
    with traced("enable"):
        bundle.lm_run(prob, st, cams, 3)
    recs = timing.records()
    steps = [r for r in recs if r.name == "ba.lm_step"]
    assert len(steps) == 3 and len({r.id for r in steps}) == 3
    rep = timing.report()["spans"]
    assert {n: rep[n]["count"] for n in LM_SPANS} == dict.fromkeys(LM_SPANS, 3)
    by_seq = {r.seq: r for r in recs}
    for r in recs:
        if r.name in ("ba.solve",) + (("ba.resid_jac",) if table else ()):
            assert by_seq[r.parent].name == "ba.schur"
        elif r.name != "ba.lm_step":
            assert by_seq[r.parent].name == "ba.lm_step"
        if r.name != "ba.lm_step":
            assert r.id == by_seq[r.parent].id
    check_self_times(recs)
    assert rep["ba.schur"]["self_ms"] < rep["ba.schur"]["total_ms"]


def test_explicit_wait_counts_once():
    """A counted wait inside a span raises its count, and its parents',
    by exactly one; outside every span it counts nowhere."""
    calls = []
    ev = SimpleNamespace(synchronize=lambda: calls.append(1))
    with traced("enable"):
        timing.wait(ev)
        with timing.span("outer", 7):
            with timing.span("inner"):
                timing.wait(ev)
            timing.count_sync()
            timing.wait(None)
    recs = {r.name: r for r in timing.records()}
    assert calls == [1, 1]
    assert (recs["inner"].syncs, recs["outer"].syncs) == (1, 2)
    assert recs["inner"].id == 7
    assert timing.report()["spans"]["outer"]["syncs"] == 2


def test_ring_counts_drops(monkeypatch):
    """A full ring pushes its oldest records out and counts them."""
    monkeypatch.setattr(timing, "_records", deque(maxlen=3))
    with traced("enable"):
        for i in range(5):
            with timing.span("s", i):
                pass
    assert [r.id for r in timing.records()] == [2, 3, 4]
    assert timing.report()["dropped"] == 2
    timing.clear()
    assert timing.report() == {"spans": {}, "dropped": 0}


def test_tag_names_the_kind():
    with traced("enable"):
        with timing.span("mapmaker.tick") as sp:
            sp.tag("idle")
    with timing.span("mapmaker.tick") as sp:   # off: a shared no-op
        sp.tag("idle")
    assert [r.name for r in timing.records()] == ["mapmaker.tick:idle"]


class _Ev:
    """A kineto event as ``attribute_idle`` reads it."""

    def __init__(self, name, dev, start, dur, corr):
        self._v = (name, dev, start, dur, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return SimpleNamespace(name=self._v[1])

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def test_attribute_idle_synthetic():
    """Each device operation to the innermost span open at its launch, each
    idle gap to the span that launched the operation ending it."""
    def rec(name, seq, parent, a, b):
        return timing.Span(name, 0, seq, parent, a, b, 0, 0)

    recs = [rec("step", 0, -1, 100, 1000), rec("coarse", 1, 0, 200, 400),
            rec("pose", 2, 0, 500, 700)]
    evs = [
        _Ev("cudaLaunchKernel", "CPU", 150, 5, 11),     # in step, outside its children
        _Ev("cudaLaunchKernel", "CPU", 250, 5, 12),     # coarse
        _Ev("cudaMemcpyAsync", "CPU", 600, 5, 13),      # pose
        _Ev("cudaLaunchKernel", "CPU", 1500, 5, 14),    # after every span
        _Ev("aten::add", "CPU", 250, 5, 12),            # a host op, not a launch
        _Ev("k1", "CUDA", 1000, 100, 11),
        _Ev("k2", "CUDA", 1050, 100, 12),               # overlaps k1: no gap
        _Ev("copy", "CUDA", 1400, 50, 13),              # gap 250 -> pose
        _Ev("k4", "CUDA", 2000, 10, 14),                # gap 550 -> no span
        _Ev("k5", "CUDA", 2020, 10, 99),                # launch unknown; gap 10
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs)))
    got = timing.attribute_idle(prof, recs)
    ns = 1e-9
    assert got == {
        "step": {"ops": 1, "device_s": pytest.approx(100 * ns), "idle_s": 0.0},
        "coarse": {"ops": 1, "device_s": pytest.approx(100 * ns), "idle_s": 0.0},
        "pose": {"ops": 1, "device_s": pytest.approx(50 * ns), "idle_s": pytest.approx(250 * ns)},
        "(no span)": {"ops": 2, "device_s": pytest.approx(20 * ns),
                      "idle_s": pytest.approx(560 * ns)},
    }


def test_benchmark_names_still_intercept(scene, monkeypatch):
    """The names the benchmark patches are looked up at call time: a
    wrapper put on each sees every call, find_patches with its pair
    indices at position 2 and its search range at position 6."""
    seen = {}

    def wrap(mod, attr, check=None):
        orig = getattr(mod, attr)

        def hooked(*a, **k):
            seen[attr] = seen.get(attr, 0) + 1
            if check:
                check(a)
            return orig(*a, **k)
        monkeypatch.setattr(mod, attr, hooked)

    def find_patches_args(a):
        assert a[2].dim() == 1 and int(a[6]) > 0

    wrap(system_mod, "make_frame_features")
    wrap(system_mod, "track_frame")
    wrap(batch_patch, "find_patches", find_patches_args)
    wrap(bundle, "spd_solve")
    sys_ = make_system(scene)
    with traced("enable"):
        sys_.process_frames(scene[3][:2])
        prob, cams = build(4, 64, 2, H=120, W=160, sparse_k=512, device="cpu")
        prob = bundle.attach_obs_table(prob, 16)
        bundle.lm_run(prob, bundle.create_lm_state(prob), cams, 2)
    assert seen["make_frame_features"] == 2 and seen["track_frame"] == 2
    assert seen["find_patches"] == 4 and seen["spd_solve"] == 2
    assert dataclasses.asdict(sys_._inflight[0].timings[0])["total"] > 0
