"""Port parity of the slice: the map builder, the whole batched step
(features -> tracker -> point stats -> add heuristic -> packed scalars)
against the JAX System's compiled batch step, the host drain, the add
heuristic's distance to queued MKFs, and process_frames with the
map-maker ticking against the JAX System.process_frames.

Both packages get the same uint8 frames and the same map.  Tolerances:
  * lost / quality / add flags, map counts, tracker lost counter: exact;
  * found counts within 1% (the ZMSSD argmin may flip on near-ties, see
    tests/test_torch_patch.py);
  * poses within 1e-4 (rotation entries and metres; the scene is ~6 m
    deep), covariances within 1% of their largest entry: each comes out of
    20 Gauss-Newton iterations of f32 normal equations summed in another
    order;
  * per-point inlier/outlier tallies equal on >= 99% of the points;
  * with the map-maker on: FrameInfo flags, added_mkf, MKF and point
    counts and the scheduler's state exact; MKF poses 1e-4.  The JAX
    builder's scatter fault is repaired in-process for that test, as in
    tests/test_torch_mapmaker.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    C, H, MAX_MEAS, MAX_MKFS, MAX_POINTS, SEED, W, jax_builder_drops_unplaced,
    jax_map, jax_scene, mapping_scene, n, np_get, port_scene, t, traj_tangent,
)

from mcptam_tpu.config import MapMakerConfig, TrackerConfig
from mcptam_tpu.core.se3 import SE3 as JSE3
from mcptam_tpu.map import builder as jbuilder
from mcptam_tpu.map.keyframe import make_frame_features as j_features
from mcptam_tpu.map.state import create_map_state as j_create
from mcptam_tpu.system.system import System as JSystem
from mcptam_tpu.tracker.tracker import create_tracker_state as j_create_tracker_state
from mcptam_tpu_torch import config as pconfig, convert
from mcptam_tpu_torch.core.se3 import SE3
from mcptam_tpu_torch.map import builder as pbuilder
from mcptam_tpu_torch.map.keyframe import make_frame_features as p_features
from mcptam_tpu_torch.map.state import create_map_state as p_create
from mcptam_tpu_torch.system.system import System, _Batch

TCFG = dict(max_patches_per_frame=200, coarse_max=20, coarse_min=6)
B = 2


def _port_system(pipeline_depth=0):
    cams, cfb, cams_sbi, ms, _ = port_scene()
    sys_ = System(cams, cfb, cams_sbi, H, W, pconfig.TrackerConfig(**TCFG),
                  pconfig.MapMakerConfig(), MAX_POINTS, MAX_MKFS, MAX_MEAS,
                  pipeline_depth=pipeline_depth)
    sys_.ms = ms
    sys_.initialized = True
    return sys_


@pytest.fixture(scope="module")
def stepped():
    """One B-frame batch through both packages, from the same state."""
    cams, cfb, cams_sbi, ms, frames = jax_scene()
    jsys = JSystem(cams, cfb, cams_sbi, H, W, TrackerConfig(**TCFG),
                   MapMakerConfig(), MAX_POINTS, MAX_MKFS, MAX_MEAS)
    # the batch step donates its state: hand it a copy of the shared map
    jsys.ms, jsys.initialized = jax.tree_util.tree_map(jnp.copy, ms), True
    images = jnp.asarray(frames[1:1 + B])
    ca = jnp.ones((C,), bool)
    ts0 = np_get(jsys.ts)
    jts, jms, jscal, jres = jsys._get_batch_fn(B)(
        jsys.ts, jsys.ms, images, ca, jsys._empty_queue_poses)
    jinfos = jsys._drain_batch(("b", 0, jscal, images, ca, jres),
                               do_actions=False)

    psys = _port_system()
    psys.ts = convert.tracker_state_from_numpy(ts0, device="cpu")
    pts, pms, pscal, _ = psys._batch_step(
        psys.ts, psys.ms, t(frames[1:1 + B]), torch.ones(C, dtype=torch.bool))
    return dict(jts=np_get(jts), jms=np_get(jms), jscal=np.asarray(jscal),
                jinfos=jinfos, pts=convert.to_numpy(pts),
                pms=convert.to_numpy(pms), pscal=n(pscal),
                jfn=jsys._get_batch_fn(B))


def test_packed_scalars_match(stepped):
    j, p = stepped["jscal"], stepped["pscal"]
    assert p.shape == j.shape == (B, 54)
    np.testing.assert_array_equal(p[:, [0, 1, 2, 4, 5]], j[:, [0, 1, 2, 4, 5]])
    assert np.all(j[:, 3] > 50), j[:, 3]
    np.testing.assert_allclose(p[:, 3], j[:, 3], rtol=0.01)
    np.testing.assert_allclose(p[:, 6:18], j[:, 6:18], rtol=0, atol=1e-4)
    cov_j, cov_p = j[:, 18:].reshape(B, 6, 6), p[:, 18:].reshape(B, 6, 6)
    scale = np.abs(cov_j).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(cov_p / scale, cov_j / scale, rtol=0, atol=0.01)


def test_tracker_state_matches(stepped):
    j, p = stepped["jts"], stepped["pts"]
    np.testing.assert_allclose(p["pose"]["R"], j.pose.R, rtol=0, atol=1e-4)
    np.testing.assert_allclose(p["pose"]["t"], j.pose.t, rtol=0, atol=1e-4)
    np.testing.assert_allclose(p["vel"], j.vel, rtol=0, atol=1e-4)
    for name in ("have_prev", "lost_count", "quality"):
        np.testing.assert_array_equal(p[name], getattr(j, name))
    np.testing.assert_allclose(p["sbi_prev"], j.sbi_prev, rtol=0, atol=1e-4)


def test_point_tallies_match(stepped):
    j, p = stepped["jms"].points, stepped["pms"]["points"]
    touched = (j.in_count + j.out_count + p["in_count"] + p["out_count"]) > 0
    assert touched.sum() > 50
    same = ((p["in_count"] == j.in_count) & (p["out_count"] == j.out_count))
    assert same[touched].mean() >= 0.99, same[touched].mean()
    np.testing.assert_array_equal(p["bad"], j.bad)


def test_drain_matches(stepped):
    psys = _port_system()
    pinfos = psys._drain_batch(_Batch(0, torch.as_tensor(stepped["pscal"]), None, B),
                               do_actions=False)
    for pi, ji in zip(pinfos, stepped["jinfos"]):
        assert pi.frame_id == ji.frame_id
        for name in ("quality", "lost", "n_points", "n_mkfs", "relocalized",
                     "added_mkf"):
            assert getattr(pi, name) == getattr(ji, name), name
        assert abs(pi.n_found - ji.n_found) <= 0.01 * ji.n_found
        np.testing.assert_allclose(pi.pose, ji.pose, rtol=0, atol=1e-4)
        # world-frame, quality-inflated covariance: same relative bar
        s = np.abs(ji.cov).max()
        np.testing.assert_allclose(pi.cov / s, ji.cov / s, rtol=0, atol=0.01)


def test_process_frames_pipeline_and_gates():
    """process_frames drains every frame once, in order, through the
    pipeline; on an uninitialised system it bootstraps the map; with
    AddingMKFs on, a frame far from the map's MKF queues a keyframe, which
    the next map-maker tick integrates or rejects."""
    frames = jax_scene()[-1]
    sys_ = _port_system(pipeline_depth=2)
    sys_.vars["AddingMKFs"] = False
    out = sys_.process_frames(t(frames[:2]))
    assert out == []                       # 2 frames in flight, depth 2
    out += sys_.process_frames(t(frames[1:3]))
    assert [i.frame_id for i in out] == [0, 1]
    out += sys_.flush_pipeline()
    assert [i.frame_id for i in out] == [0, 1, 2, 3]
    assert not any(i.lost for i in out)
    assert all(i.n_found > 50 for i in out)

    # an uninitialised system bootstraps its own map from the first frame
    # (process_frames falls back to process_frame) instead of skipping it
    fresh = _port_system()
    fresh.ms = p_create(H, W, C, fresh.cam_from_base, MAX_POINTS, MAX_MKFS, MAX_MEAS)
    fresh.initialized = False
    out = fresh.process_frames(t(frames[:1]))
    assert fresh.initialized and [i.frame_id for i in out] == [0]
    assert int(fresh.ms.mkfs.valid.sum()) == 1 and out[0].n_points >= 20

    # a far-away MKF pose makes the add heuristic fire on a good frame
    adder = _port_system()
    adder.ms.mkfs.base_from_world.t[0] += torch.tensor([0.0, 0.0, 0.5])
    out = adder.process_frames(t(frames[:1]))
    assert [i.added_mkf for i in out] == [True]
    assert adder.mapmaker.queue_size() == 0
    assert adder.mapmaker.last_timing.kind in ("creation", "creation-rejected")


def test_reset_keeps_pose():
    """reset(keep_pose=True), the reset after repeated failed BAs: a fresh
    map and tracker at the old pose, the map-maker cleared, the frames in
    flight dropped and counted."""
    frames = jax_scene()[-1]
    sys_ = _port_system(pipeline_depth=4)
    sys_.vars["AddingMKFs"] = False
    assert sys_.process_frames(t(frames[:2])) == []
    pose = sys_.ts.pose
    sys_.mapmaker.add_mkf(None, pose, None)
    sys_.reset(keep_pose=True)
    assert sys_.last_reset_dropped == 2 and not sys_.initialized
    assert int(sys_.ms.mkfs.valid.sum()) == 0 and sys_.mapmaker.queue_size() == 0
    np.testing.assert_array_equal(n(sys_.ts.pose.t), n(pose.t))
    np.testing.assert_array_equal(n(sys_.ts.pose.R), n(pose.R))


def _queue(tangent, valid):
    """Queue-pose slots (2 of them) holding one MKF at ``tangent``."""
    from mcptam_tpu.core.se3 import SE3 as JSE3
    p = JSE3.exp(jnp.asarray(tangent))
    qR = np.stack([np.asarray(p.R), np.eye(3, dtype=np.float32)])
    qt = np.stack([np.asarray(p.t), np.zeros(3, np.float32)])
    return qR, qt, np.array([6.0, 1.0], np.float32), np.array([valid, False])


def test_queue_distance_repair(stepped):
    """The add heuristic measures the distance to MKFs still queued in the
    map-maker (NeedNewMultiKeyFrame): with the map's MKF moved away every
    frame asks for a keyframe, and a queued MKF at the frames' own pose
    silences them — in both packages, on the same packed scalars."""
    from mcptam_tpu.tracker.tracker import create_tracker_state as j_cts
    cams, cfb, cams_sbi, ms, frames = jax_scene()
    far = ms.mkfs.base_from_world.t.at[0].add(jnp.asarray([0.0, 0.0, 0.5]))
    jms = ms.replace(mkfs=ms.mkfs.replace(
        base_from_world=ms.mkfs.base_from_world.replace(t=far)))
    images = jnp.asarray(frames[1:1 + B])
    for valid in (False, True):
        q = _queue(traj_tangent(1), valid)
        _, _, jscal, _ = stepped["jfn"](
            j_cts(C), jax.tree_util.tree_map(jnp.copy, jms), images,
            jnp.ones((C,), bool), tuple(map(jnp.asarray, q)))
        psys = _port_system()
        psys.ms.mkfs.base_from_world.t[0] += torch.tensor([0.0, 0.0, 0.5])
        _, _, pscal, _ = psys._batch_step(
            psys.ts, psys.ms, t(frames[1:1 + B]), torch.ones(C, dtype=torch.bool),
            tuple(map(t, q)))
        jscal, pscal = np.asarray(jscal), n(pscal)
        np.testing.assert_array_equal(pscal[:, [0, 1, 2, 4, 5]], jscal[:, [0, 1, 2, 4, 5]])
        assert (jscal[:, 2] == (0.0 if valid else 1.0)).all(), valid


# the map-maker slice: frames walking sideways away from the map's MKF;
# the add heuristic fires with margin on the second frame (scaled distance
# ~0.046 against a threshold of 0.033) and on no later one (<= 0.025 from
# the new MKF)
WALK = [0.06, 0.16, 0.18, 0.20, 0.22, 0.24]


def _walk_tangent(x):
    return np.array([x, 0.0, x / 6.0, 0.0, x / 12.0, 0.0], np.float32)


def test_process_frames_with_mapmaker_matches():
    """Three batches of two frames and a flush through process_frames with
    the map-maker ticking every batch, from the same map, tracker pose and
    frames: the same FrameInfos, keyframe add, integration, BA schedule
    and map."""
    from mcptam_tpu.core.se3 import SE3 as JSE3
    from mcptam_tpu.io.synthetic import render_rig
    from mcptam_tpu.system.mapmaker import MM_RUNNING as J_RUNNING
    from mcptam_tpu_torch.system.mapmaker import MM_RUNNING

    jcams, jcfb, _, _ = mapping_scene()
    _, _, jcams_sbi, _, _ = jax_scene()
    ms_np = mapping_scene()[2]
    frames = np.stack([np.asarray(jnp.clip(render_rig(
        jcams, jcfb, JSE3.exp(jnp.asarray(_walk_tangent(x))), SEED, H, W),
        0, 255)).astype(np.uint8) for x in WALK])

    jsys = JSystem(jcams, jcfb, jcams_sbi, H, W, TrackerConfig(**TCFG),
                   MapMakerConfig(), MAX_POINTS, MAX_MKFS, MAX_MEAS)
    jsys.ms, jsys.initialized = jax_map(ms_np), True
    jsys.mapmaker.state = J_RUNNING
    jsys.ts = jsys.ts.replace(pose=JSE3.exp(jnp.asarray(_walk_tangent(WALK[0]))))
    psys = _port_system()
    psys.ms = convert.map_state_from_numpy(ms_np, device="cpu")
    psys.mapmaker.state = MM_RUNNING
    psys.ts.pose = SE3.exp(t(_walk_tangent(WALK[0])))

    with jax_builder_drops_unplaced():
        jinfos, pinfos = [], []
        for i in range(0, len(WALK), B):
            jinfos += jsys.process_frames(jnp.asarray(frames[i:i + B]))
            pinfos += psys.process_frames(t(frames[i:i + B]))
        jinfos += jsys.flush_pipeline()
        pinfos += psys.flush_pipeline()

    assert [i.frame_id for i in pinfos] == [i.frame_id for i in jinfos] == list(range(6))
    assert [i.added_mkf for i in jinfos] == [False, True, False, False, False, False]
    for pi, ji in zip(pinfos, jinfos):
        for name in ("quality", "lost", "n_points", "n_mkfs", "added_mkf", "mm_state"):
            assert getattr(pi, name) == getattr(ji, name), (ji.frame_id, name)
        assert abs(pi.n_found - ji.n_found) <= 0.01 * ji.n_found
        np.testing.assert_allclose(pi.pose, ji.pose, rtol=0, atol=1e-4)
    jmm, pmm = jsys.mapmaker, psys.mapmaker
    assert jmm.last_timing.kind == pmm.last_timing.kind
    for name in ("_ba_kind", "_local_done", "_global_done", "failed_ba_count", "state"):
        assert getattr(pmm, name) == getattr(jmm, name), name
    assert pmm.queue_size() == jmm.queue_size() == 0
    j, p = np_get(jsys.ms), convert.to_numpy(psys.ms)
    assert int(j.mkfs.valid.sum()) == int(p["mkfs"]["valid"].sum()) == 2
    np.testing.assert_array_equal(p["points"]["valid"], j.points.valid)
    np.testing.assert_array_equal(p["meas"]["valid"], j.meas.valid)
    np.testing.assert_allclose(p["mkfs"]["base_from_world"]["t"],
                               j.mkfs.base_from_world.t, rtol=0, atol=1e-4)


def test_builder_matches():
    """commit_mkf + add_points on identical features and requests that are
    all placed: the same points, windows, rays and measurements."""
    cams, cfb, _, _, frames = jax_scene()
    jfeats = jax.jit(j_features)(jnp.asarray(frames[0]))
    pfeats = p_features(t(frames[0]))
    pcams = convert.camera_from_numpy(np_get(cams), device="cpu")
    pcfb = convert.se3_from_numpy(np_get(cfb), device="cpu")
    jms = j_create(H, W, C, cfb, 64, 2, 128)
    pms = p_create(H, W, C, pcfb, 64, 2, 128)
    jms, jidx, _ = jax.jit(jbuilder.commit_mkf, static_argnames="fixed")(
        jms, jfeats, JSE3.identity(), fixed=True)
    pms, pidx, _ = pbuilder.commit_mkf(pms, pfeats, SE3.identity(), fixed=True)
    assert int(pidx) == int(jidx)
    lvl, q = 1, 12
    valid = np.asarray(jfeats.cand_valid[lvl][:, :q])
    assert valid.all()
    xy = np.asarray(jfeats.cand_xy[lvl][:, :q]).reshape(-1, 2).astype(np.float32)
    cam = np.repeat(np.arange(C, dtype=np.int32), q)
    pos = np.random.default_rng(0).normal(size=(C * q, 3)).astype(np.float32)
    pos[:, 2] += 6.0
    args = (cam, np.full(C * q, lvl, np.int32), xy, pos, np.ones(C * q, bool))
    # every request is placed, so the jitted JAX builder is exact here
    jms, _, _ = jax.jit(jbuilder.add_points)(jms, cams, jidx, *map(jnp.asarray, args))
    pms, _, _ = pbuilder.add_points(pms, pcams, pidx, *map(t, args))
    j, p = np_get(jms), convert.to_numpy(pms)
    for group in ("points", "meas"):
        for f in dataclasses.fields(getattr(j, group)):
            a, b = p[group][f.name], getattr(getattr(j, group), f.name)
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=f.name)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f.name)
    for name in ("valid", "fixed", "kf_valid", "atlas", "corner_atlas", "seq"):
        np.testing.assert_array_equal(p["mkfs"][name], getattr(j.mkfs, name))


def test_port_places_every_wanted_request():
    """Unplaced requests must not disturb the slot of the first placed one
    (the JAX builder's scatter reverts it; see ROADMAP section C)."""
    _, cfb, _, _, frames = port_scene()
    cams = port_scene()[0]
    feats = p_features(t(frames[0]))
    ms = p_create(H, W, C, cfb, 16, 2, 64)
    ms, idx, _ = pbuilder.commit_mkf(ms, feats, SE3.identity())
    want = torch.tensor([True, False, True, False])
    xy = feats.cand_xy[0][0, :4].to(torch.float32)
    pos = torch.tensor([[0.0, 0.0, 6.0]]).expand(4, 3) + torch.arange(4.0)[:, None]
    ms, slot, ok = pbuilder.add_points(
        ms, cams, idx, torch.zeros(4, dtype=torch.int32),
        torch.zeros(4, dtype=torch.int32), xy, pos, want)
    assert ok.tolist() == [True, False, True, False]
    assert int(ms.points.valid.sum()) == 2
    placed = slot[ok]
    np.testing.assert_array_equal(n(ms.points.pos_w[placed]), n(pos[ok]))
    assert int(ms.meas.valid.sum()) == 2


def test_convert_round_trip():
    """JAX pytrees (as numpy) -> port dataclasses -> numpy: every carried
    leaf comes back unchanged, dtypes included."""
    cams, cfb, _, ms, frames = jax_scene()
    jts = np_get(j_create_tracker_state(C))
    jfeats = np_get(jax.jit(j_features)(jnp.asarray(frames[0])))
    cases = [
        (convert.camera_from_numpy, np_get(cams)),
        (convert.se3_from_numpy, np_get(cfb)),
        (convert.map_state_from_numpy, np_get(ms)),
        (convert.tracker_state_from_numpy, jts),
        (convert.frame_features_from_numpy, jfeats),
    ]

    def check(back, ref):
        if isinstance(back, dict):
            for k, v in back.items():
                check(v, getattr(ref, k))
        elif isinstance(back, tuple):
            for a, b in zip(back, ref):
                check(a, b)
        else:
            assert back.dtype == np.asarray(ref).dtype
            np.testing.assert_array_equal(back, ref)

    for fn, src in cases:
        check(convert.to_numpy(fn(src, device="cpu")), src)
