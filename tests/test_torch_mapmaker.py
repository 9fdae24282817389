"""Port parity of the map-maker: the pair-batched keyframe patch search
(ops/patch.py ``*_w``), refinds (map/refind.py), epipolar point creation
(map/epipolar.py), keyframe integration (map/mapmaker_core.py) and the
scheduler (system/mapmaker.py), against the JAX package's per-pair
functions and jitted programs.

The scene is _torch_parity.mapping_scene: a ground-truth map of 12
candidates a level and keyframes rendered 0.12 m apart sideways.  The map
is built by the port and carried into the JAX MapState; features are the
JAX package's, carried into the port.

The JAX builder's known scatter fault (ROADMAP section C: an unplaced
request shares a slot with the first placed one, and under jit its write
reverts that slot) is repaired in this process for these tests, by
sending unplaced requests out of range where JAX drops the write — the
behaviour of the port's builder.  The package itself is unchanged; without
the repair the first measurement or point of every partly placed request
batch is lost in the JAX maps and no integration could be compared.

Tolerances:
  * found flags, argmin positions, search levels, created-point and
    measurement sets, every integer and flag of the map: exact (the SSD
    argmins and the epipolar tests have margins on this scene: the same
    sets come out of both packages);
  * SSD scores 8 absolute (the score cancels sums of ~64 * 255^2 in f32);
    subpixel positions 2e-3 px; warped templates 1e-3 grey levels where
    they are valid (outside the source window the JAX bilinear extrapolates
    and the port clamps; such templates are never used);
  * triangulated points: 2e-3 m for most, and 2% of their depth for all:
    the midpoint method's denominator 1 - cos^2(parallax) cancels ~6 digits
    in f32 for the near-parallel rays of this 0.12 m baseline, and the
    pixel vectors computed from those points follow them;
  * the rest of the float state 1e-3 relative; after a bundle adjustment
    poses 1e-4 and points as above (see tests/test_torch_bundle.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    C, MKF_TANGENTS, jax_builder_drops_unplaced, jax_map, mapping_scene, n, np_get,
    synthetic_track_result, t,
)

from mcptam_tpu.config import BundleConfig as JBC, MapMakerConfig as JMC
from mcptam_tpu.core.se3 import SE3 as JSE3
from mcptam_tpu.map import epipolar as jepi, mapmaker_core as jmc, refind as jrf
from mcptam_tpu.map.builder import commit_mkf as j_commit
from mcptam_tpu.ops import patch as jpatch
from mcptam_tpu.system.mapmaker import MM_RUNNING as J_RUNNING, MapMaker as JMapMaker
from mcptam_tpu_torch import convert
from mcptam_tpu_torch.config import BundleConfig as PBC, MapMakerConfig as PMC
from mcptam_tpu_torch.core.se3 import SE3
from mcptam_tpu_torch.map import epipolar as pepi, mapmaker_core as pmc, refind as prf
from mcptam_tpu_torch.map.builder import commit_mkf as p_commit
from mcptam_tpu_torch.ops import patch as ppatch
from mcptam_tpu_torch.system.mapmaker import MM_RUNNING, MapMaker
from mcptam_tpu_torch.tracker.tracker import TrackResult

RANGE = 7


@pytest.fixture(autouse=True, scope="module")
def _repaired_jax_builder():
    with jax_builder_drops_unplaced():
        yield


@pytest.fixture(scope="module")
def scene():
    jcams, _, ms_np, feats = mapping_scene()
    pcams = convert.camera_from_numpy(np_get(jcams), device="cpu")
    return jcams, pcams, ms_np, feats


POINT_GEOMETRY = ("pos_w", "pixel_right_w", "pixel_down_w")


def _cmp_points(a, b, key):
    """Per-point rows: all within 2% of their norm, 97% within 2e-3."""
    d = np.abs(a - b).max(-1)
    scale = np.maximum(np.abs(b).max(-1), 1e-6)
    assert (d <= 0.02 * scale + 1e-6).all(), (key, (d / scale).max())
    assert (d <= 2e-3 * np.maximum(scale, 1.0)).mean() >= 0.97, key


def _cmp_map(p, j, atol=1e-3, rtol=1e-3, loose=False):
    """Port map (convert.to_numpy) against a JAX map (numpy tree)."""
    for key, val in p.items():
        ref = getattr(j, key)
        if isinstance(val, dict):
            _cmp_map(val, ref, atol, rtol, loose)
        elif key in POINT_GEOMETRY:
            _cmp_points(val, np.asarray(ref), key)
        elif val.dtype.kind == "f":
            tol = {"t": 1e-4, "R": 1e-4} if loose else {}
            np.testing.assert_allclose(val, ref, rtol=rtol,
                                       atol=tol.get(key, atol), err_msg=key)
        else:
            np.testing.assert_array_equal(val, ref, err_msg=key)


# ---------------------------------------------------------------------------
# the pair-batched keyframe patch search
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pairs(scene):
    """K pairs in keyframe (0, cam) at the map points' own corners: the
    search level is the point's level, the prediction 2 px (level 0) off,
    the warp a small rotation of the identity."""
    _, _, ms_np, _ = scene
    pts = ms_np["points"]
    ids = np.flatnonzero(pts["valid"])
    rng = np.random.default_rng(1)
    K = len(ids)
    lvl = pts["src_level"][ids].astype(np.int32)
    xy = pts["center_xy"][ids].astype(np.float32)
    a = rng.normal(size=K) * 0.05
    rot = np.stack([np.stack([np.cos(a), -np.sin(a)], -1),
                    np.stack([np.sin(a), np.cos(a)], -1)], 1)
    warp = (rot * (2.0 ** lvl)[:, None, None]).astype(np.float32)
    xy0 = (xy + 0.5) * (2.0 ** lvl)[:, None] - 0.5
    pred = (xy0 + rng.normal(size=(K, 2)) * 2.0).astype(np.float32)
    return dict(mkf=np.zeros(K, np.int32), cam=pts["src_cam"][ids].astype(np.int32),
                lvl=lvl, xy=xy, warp=warp, pred=pred)


def _jax_window_fns(ms_np, m, c):
    atlas = jnp.asarray(ms_np["mkfs"]["atlas"])
    corner = jnp.asarray(ms_np["mkfs"]["corner_atlas"])
    return jpatch.make_window_fn4(atlas, m, c), jpatch.make_window_fn4(corner, m, c)


def test_patch_search_w_matches(scene, pairs):
    """Templates (compared where valid), then the search and the subpixel
    refinement from the same templates in both packages."""
    _, _, ms_np, _ = scene
    pr = pairs
    atlas = t(ms_np["mkfs"]["atlas"])
    corner = t(ms_np["mkfs"]["corner_atlas"])
    mkf, cam, lvl = t(pr["mkf"]), t(pr["cam"]), t(pr["lvl"])
    tmpl, t_ok = ppatch.make_warped_template_w(atlas, mkf, cam, lvl, t(pr["xy"]),
                                               t(pr["warp"]), lvl)
    found, pos, ssd = ppatch.find_patch_w(atlas, corner, mkf, cam, lvl, tmpl,
                                          t(pr["pred"]), RANGE)
    sub, conv = ppatch.subpix_refine_w(atlas, mkf, cam, lvl, tmpl, pos, 10)
    p = [n(x) for x in (tmpl, t_ok, found, pos, ssd, sub, conv)]

    @jax.jit
    def jrun(m, c, lvl, xy, warp, pred, tm):
        def one(m, c, lvl, xy, warp, pred, tm):
            fn, crn = _jax_window_fns(ms_np, m, c)
            tmpl, t_ok = jpatch.make_warped_template_w(fn, lvl, xy, warp, lvl)
            found, pos, ssd = jpatch.find_patch_w(fn, crn, lvl, tm, pred, RANGE)
            sub, conv = jpatch.subpix_refine_w(fn, lvl, tm, pos, 10)
            return tmpl, t_ok, found, pos, ssd, sub, conv
        return jax.vmap(one)(m, c, lvl, xy, warp, pred, tm)

    j = [np.asarray(x) for x in jrun(*(jnp.asarray(pr[k]) for k in
                                       ("mkf", "cam", "lvl", "xy", "warp", "pred")),
                                     jnp.asarray(p[0]))]
    np.testing.assert_array_equal(p[1], j[1])
    assert p[1].mean() > 0.8
    np.testing.assert_allclose(p[0][p[1]], j[0][p[1]], rtol=0, atol=1e-3)
    for k in (2, 3, 6):                     # found, argmin positions, converged
        np.testing.assert_array_equal(p[k], j[k])
    ok = j[2]
    assert ok.mean() > 0.8 and j[6][ok].mean() > 0.5
    np.testing.assert_allclose(p[4][ok], j[4][ok], rtol=0, atol=8.0)
    np.testing.assert_allclose(p[5], j[5], rtol=0, atol=2e-3)


def test_zmssd_matches():
    rng = np.random.default_rng(2)
    tm = rng.uniform(0, 255, (8, 8)).astype(np.float32)
    pt = rng.uniform(0, 255, (5, 8, 8)).astype(np.float32)
    np.testing.assert_allclose(n(ppatch.zmssd(t(tm), t(pt))),
                               np.asarray(jpatch.zmssd(jnp.asarray(tm), jnp.asarray(pt))),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# refinds, epipolar matching, integration
# ---------------------------------------------------------------------------

def _committed(scene, k=0):
    """The ground-truth map with MKF k's imagery committed, both packages."""
    jcams, pcams, ms_np, feats = scene
    pose_v = MKF_TANGENTS[k]
    jms, jidx, _ = jax.jit(j_commit)(jax_map(ms_np), jax.tree_util.tree_map(
        jnp.asarray, feats[k]), JSE3.exp(jnp.asarray(pose_v)))
    pms, pidx, _ = p_commit(convert.map_state_from_numpy(ms_np, device="cpu"),
                            convert.frame_features_from_numpy(feats[k], device="cpu"),
                            SE3.exp(t(pose_v)))
    assert int(jidx) == int(pidx) == 1
    return jms, pms, pidx


@pytest.mark.parametrize("pair_mask", [False, True])
def test_refind_matches(scene, pair_mask):
    """Refinds into the newly committed keyframes; with pair_mask, only a
    random half of the (keyframe, point) pairs (the failure-queue path)."""
    jcams, pcams, _, _ = scene
    jms, pms, idx = _committed(scene)
    np.testing.assert_array_equal(n(prf.measurement_table(pms)),
                                  np.asarray(jrf.measurement_table(jms)))
    target = np.zeros(jms.mkfs.valid.shape[0], bool)
    target[int(idx)] = True
    pm = (np.random.default_rng(3).random(jms.no_retry.shape) < 0.5) if pair_mask else None
    jfn = jax.jit(lambda ms, tg, pm: jrf.refind_in_keyframes(ms, jcams, tg, pair_mask=pm))
    jout, jn = jfn(jms, jnp.asarray(target), None if pm is None else jnp.asarray(pm))
    pout, pn = prf.refind_in_keyframes(pms, pcams, t(target),
                                       pair_mask=None if pm is None else t(pm))
    assert int(pn) == int(jn) > 5
    _cmp_map(convert.to_numpy(pout), np_get(jout), atol=2e-3)


@pytest.mark.parametrize("corner", [False, True])
def test_epipolar_match_matches(scene, corner):
    """The strongest level-2 and level-1 candidates of both cameras of the
    new keyframe against keyframe (0, same camera), under both ambiguity
    rules."""
    jcams, pcams, _, feats = scene
    jms, pms, idx = _committed(scene)
    pfeats = convert.frame_features_from_numpy(feats[0], device="cpu")
    xs, cams_, lv = [], [], []
    for level in (2, 1):
        for c in range(C):
            xy, want = pmc._level_candidates(pfeats, c, level, 32)
            xs.append(n(xy)[n(want)])
            cams_ += [c] * int(want.sum())
            lv += [level] * int(want.sum())
    xy = np.concatenate(xs).astype(np.float32)
    Q = len(xy)
    args = dict(src_mkf=np.full(Q, int(idx), np.int32), src_cam=np.array(cams_, np.int32),
                tgt_mkf=np.zeros(Q, np.int32), tgt_cam=np.array(cams_, np.int32),
                level=np.array(lv, np.int32), xy_level=xy, want=np.ones(Q, bool))
    jout = jax.jit(lambda ms, a: jepi.epipolar_match(
        ms, jcams, **a, corner_ambiguity=corner))(jms, {k: jnp.asarray(v) for k, v in args.items()})
    pout = pepi.epipolar_match(pms, pcams, **{k: t(v) for k, v in args.items()},
                               corner_ambiguity=corner)
    jok, pok = np.asarray(jout[0]), n(pout[0])
    np.testing.assert_array_equal(pok, jok)
    assert jok.sum() >= 10
    np.testing.assert_array_equal(n(pout[3])[jok], np.asarray(jout[3])[jok])
    _cmp_points(n(pout[1])[jok], np.asarray(jout[1])[jok], "pos_w")
    np.testing.assert_allclose(n(pout[2])[jok], np.asarray(jout[2])[jok], rtol=0, atol=2e-3)


def test_triangulate_and_budget_match(scene):
    jcams, pcams, ms_np, _ = scene
    rng = np.random.default_rng(4)
    o1, o2 = rng.normal(size=(2, 16, 3)).astype(np.float32)
    d1, d2 = rng.normal(size=(2, 16, 3)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    jp, jok = jepi.triangulate_midpoint(*map(jnp.asarray, (o1, d1, o2, d2)))
    pp, pok = pepi.triangulate_midpoint(*map(t, (o1, d1, o2, d2)))
    np.testing.assert_array_equal(n(pok), np.asarray(jok))
    np.testing.assert_allclose(n(pp), np.asarray(jp), rtol=1e-4, atol=1e-4)
    cfb = jax_map(ms_np).cam_from_base
    pcfb = convert.se3_from_numpy(np_get(cfb), device="cpu")
    for base in (0.0, 0.6, 3.0):
        assert (pepi.auto_hypothesis_budget(pcams, pcfb, kf_baseline=base)
                == jepi.auto_hypothesis_budget(jcams, cfb, kf_baseline=base))


def test_integrate_with_tracker_result_matches(scene):
    """integrate_mkf_device with a tracker result: commit, the tracker's
    measurements, refinds, the "other" and "self" epipolar passes."""
    jcams, pcams, ms_np, feats = scene
    res = synthetic_track_result(ms_np, pcams, MKF_TANGENTS[0])
    jres = type("Res", (), {k: jnp.asarray(v) for k, v in res.items()})
    pres = TrackResult(**{f.name: (t(res[f.name]) if f.name in res else None)
                          for f in dataclasses.fields(TrackResult)})
    pose = MKF_TANGENTS[0]
    ca = np.ones(C, bool)
    jout = jax.jit(lambda ms, f, p, ca: jmc.integrate_mkf_device(
        ms, jcams, f, p, jres, JMC(), cam_active=ca))(
        jax_map(ms_np), jax.tree_util.tree_map(jnp.asarray, feats[0]),
        JSE3.exp(jnp.asarray(pose)), jnp.asarray(ca))
    pout = pmc.integrate_mkf_device(
        convert.map_state_from_numpy(ms_np, device="cpu"), pcams,
        convert.frame_features_from_numpy(feats[0], device="cpu"), SE3.exp(t(pose)), pres, PMC(),
        cam_active=t(ca))
    assert int(pout[1]) == int(jout[1]) and bool(pout[3]) and bool(jout[3])
    assert int(pout[2]) == int(jout[2]) > 0              # large points
    _cmp_map(convert.to_numpy(pout[0]), np_get(jout[0]))
    jm = np_get(jout[0]).meas
    assert (jm.valid & (jm.source == 1)).sum() > 30      # SRC_TRACKER measurements


def test_need_new_mkf_queue_distance(scene):
    """The add heuristic measures distance to the MKFs still queued in the
    map-maker too: a pose far from the map but next to a queued MKF adds
    nothing, in both packages."""
    _, _, ms_np, _ = scene
    jms, pms = jax_map(ms_np), convert.map_state_from_numpy(ms_np, device="cpu")
    far = np.array([0.4, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)
    for qd in (None, 0.01):
        ja, js = jmc.need_new_mkf(jms, JSE3.exp(jnp.asarray(far)), jnp.asarray(6.0),
                                  queue_dist=None if qd is None else jnp.asarray(qd))
        pa, ps = pmc.need_new_mkf(pms, SE3.exp(t(far)), torch.tensor(6.0),
                                  queue_dist=None if qd is None else torch.tensor(qd))
        assert bool(pa) == bool(ja) == (qd is None)
        np.testing.assert_allclose(float(ps), float(js), rtol=1e-5)


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

def test_mapmaker_tick_sequence_matches(scene):
    """One fixed sequence through both schedulers, the maps compared after
    every tick: queue + integrate MKF 1; local BA (recent_min_size 2) in
    two chunks of 5 steps, finished by max_iterations 10; global BA, one
    chunk, preempted by MKF 2 (partial writeback + integration); local and
    global BA again; then idle GC and the refind sweep."""
    jcams, pcams, ms_np, feats = scene
    jmm = JMapMaker(cams=jcams, mcfg=JMC(), bcfg=JBC(recent_min_size=2, max_iterations=10))
    pmm = MapMaker(cams=pcams, mcfg=PMC(), bcfg=PBC(recent_min_size=2, max_iterations=10))
    jmm.state, pmm.state = J_RUNNING, MM_RUNNING
    jms, pms = jax_map(ms_np), convert.map_state_from_numpy(ms_np, device="cpu")

    def queue(k):
        v = MKF_TANGENTS[k]
        jmm.add_mkf(jax.tree_util.tree_map(jnp.asarray, feats[k]),
                    JSE3.exp(jnp.asarray(v)), None)
        pmm.add_mkf(convert.frame_features_from_numpy(feats[k], device="cpu"), SE3.exp(t(v)), None)

    expect = [
        ("creation", "none"), ("creation", "local"), ("local", "none"),
        ("local", "global"), "queue", ("creation", "none"), ("creation", "local"),
        ("local", "none"), ("local", "global"), ("global", "none"),
    ]
    queue(0)
    loose = False
    for step in expect:
        if step == "queue":
            queue(1)
            continue
        jms, pms = jmm.step(jms), pmm.step(pms)
        assert pmm.last_timing.kind == jmm.last_timing.kind == step[0], step
        assert pmm._ba_kind == jmm._ba_kind == step[1], step
        loose = loose or step[0] in ("local", "global") or step[1] != "none"
        _cmp_map(convert.to_numpy(pms), np_get(jms), loose=loose)
    assert pmm.failed_ba_count == jmm.failed_ba_count == 0
    assert int(np.asarray(jms.mkfs.valid).sum()) == 3

    # idle: GC, then (ticks 10, 30, ...) the general refind sweep
    for mm in (jmm, pmm):
        mm._idle_ticks = 9
    jms, pms = jmm.step(jms), pmm.step(pms)
    assert pmm._idle_ticks == jmm._idle_ticks == 10
    _cmp_map(convert.to_numpy(pms), np_get(jms), loose=True)
