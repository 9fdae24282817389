"""Port parity of the pose-calibration session (calib/pose_calib.py)
against the JAX package (the pose_calibrator app's test is in
tests/test_torch_extrinsic.py, beside the extrinsic calibration its
default path runs).

The session scene is scripts/zero_overlap_drive.py's board-and-sphere
world and 96x128 lens, with the second camera turned only 0.2 rad from the
first, so that both see the board on frames 0 and 3: four frames take the
session through the bootstrap of both cameras, tracking, keyframe drops
(sync groups of both cameras), background BA ticks, calib_init and
calib_step.  Both packages get the same uint8 frames and projected
detections (0.05 px noise, rng 11).  The JAX builder's scatter fault
(ROADMAP section C) is repaired in this process
(``jax_builder_drops_unplaced``).  The full 48-frame zero-overlap drive
runs on the card (chip_smoke.py phase 10).

Tolerances: running flags, sync groups, MKF slots, point and measurement
counts exact; tracked and keyframe poses 1e-4 (rotation entries and
metres: float32 Gauss-Newton and LM steps summed in another order, which
agree to ~1e-6 here); the extrinsics after calib_init and calib_step 1e-4;
init_from_calib_image's map exact but for the float32 unprojected patch
vectors (1e-6); need_new_kf exact; _base_shift_gn 1e-6 (float32 SO(3) maps
in both)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import jax_builder_drops_unplaced, n, np_get, t

from mcptam_tpu.calib import pose_calib as jpc
from mcptam_tpu.calib.board import inner_corner_points
from mcptam_tpu.config import MapMakerConfig as JMC, TrackerConfig as JTC
from mcptam_tpu.core.camera import make_camera as j_make_camera
from mcptam_tpu.core.camera import project as j_project
from mcptam_tpu.core.camera import stack_cameras as j_stack
from mcptam_tpu.core.se3 import SE3 as JSE3, so3_exp as j_so3_exp
from mcptam_tpu.io.synthetic import make_sbi_cams as j_sbi
from mcptam_tpu.io.synthetic import render_rig_board as j_render_rig_board
from mcptam_tpu.map.keyframe import make_frame_features as j_features
from mcptam_tpu_torch import convert
from mcptam_tpu_torch.calib import pose_calib as ppc
from mcptam_tpu_torch.config import MapMakerConfig as PMC, TrackerConfig as PTC
from mcptam_tpu_torch.core.se3 import SE3

H, W = 96, 128
SQUARES, SQ = (8, 6), 0.25
PARAMS = np.array([0.75 * W, -0.0035, 1.0e-6, -6.0e-9, W / 2.0 + 1.0, H / 2.0 + 1.0,
                   1.001, 0.0003, -0.0002])
REL_W, REL_T = [0.0, -0.2, 0.02], [0.22, -0.03, 0.06]       # cam1_from_cam0
BOARD2 = inner_corner_points(SQUARES, SQ).reshape(-1, 3)[:, :2]
N_FRAMES, DETECT_FRAMES = 4, (0, 3)
CAPS = dict(max_points=512, max_mkfs=8, max_meas=4096)
TCFG = dict(max_patches_per_frame=300, coarse_max=30, max_ssd_per_pixel=500.0)
POSE_TOL = 1e-4


def base_pose(i: int) -> JSE3:
    """The drive's trajectory before it turns: frontal to the board,
    translating for baseline."""
    pos = np.array([SQUARES[0] * SQ / 2 - 0.28 + 0.033 * i,
                    SQUARES[1] * SQ / 2 + 0.012 * i - 0.16, -1.7 + 0.012 * i])
    return JSE3(R=jnp.eye(3), t=jnp.asarray(-pos, jnp.float32))


@pytest.fixture(scope="module")
def scene():
    """(JAX cams, JAX cam_from_base, uint8 frames (T,C,H,W), detections)."""
    cam = j_make_camera(PARAMS, (W, H))
    cams = j_stack([cam, cam])
    rel = JSE3(R=j_so3_exp(jnp.asarray(REL_W, jnp.float32)),
               t=jnp.asarray(REL_T, jnp.float32))
    cfb = JSE3(R=jnp.stack([jnp.eye(3), rel.R]), t=jnp.stack([jnp.zeros(3), rel.t]))
    pts = jnp.asarray(np.concatenate([BOARD2, np.zeros((len(BOARD2), 1))], 1), jnp.float32)
    rng = np.random.default_rng(11)
    frames, dets = [], []
    for i in range(N_FRAMES):
        frames.append(np.asarray(jnp.clip(j_render_rig_board(
            cams, cfb, base_pose(i), 3.0, H, W, SQUARES, SQ), 0, 255)).astype(np.uint8))
        d = {}
        if i in DETECT_FRAMES:
            for c in range(2):
                pose_c = JSE3(R=cfb.R[c], t=cfb.t[c]) @ base_pose(i)
                uv, ok = j_project(cam, pose_c.apply(pts))
                uvn = np.asarray(uv) + rng.normal(size=(len(BOARD2), 2)) * 0.05
                okn = np.asarray(ok)
                d[c] = (uvn[okn], np.nonzero(okn)[0])
        dets.append(d)
    return cams, cfb, np.stack(frames), dets


def _sessions(scene):
    cams, _, _, _ = scene
    kw = dict(params9=[PARAMS, PARAMS], board_pts2=BOARD2, H=H, W=W,
              max_scaled_kf_dist=0.05, **CAPS)
    js = jpc.PoseCalibSession(cams=cams, cams_sbi=j_sbi(cams, H, W), tcfg=JTC(**TCFG),
                              mcfg=JMC(large_point_test=False), **kw)
    ps = ppc.PoseCalibSession(
        cams=convert.camera_from_numpy(np_get(cams), device="cpu"),
        cams_sbi=convert.camera_from_numpy(np_get(j_sbi(cams, H, W)), device="cpu"),
        tcfg=PTC(**TCFG), mcfg=PMC(large_point_test=False), **kw)
    return js, ps


def _assert_maps_agree(jms, pms):
    for grp, names in (("mkfs", ("valid", "kf_valid", "fixed")),
                       ("points", ("valid", "fixed", "src_mkf")),
                       ("meas", ("valid", "mkf", "cam", "point", "source"))):
        for name in names:
            np.testing.assert_array_equal(n(getattr(getattr(pms, grp), name)),
                                          np.asarray(getattr(getattr(jms, grp), name)),
                                          err_msg=f"{grp}.{name}")
    for a, b in ((pms.mkfs.base_from_world.R, jms.mkfs.base_from_world.R),
                 (pms.mkfs.base_from_world.t, jms.mkfs.base_from_world.t)):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=POSE_TOL, rtol=0)


def test_session_matches_jax(scene):
    """Frame by frame, then calib_init and calib_step(5)."""
    _, _, frames, dets = scene
    js, ps = _sessions(scene)
    with jax_builder_drops_unplaced():
        for i in range(N_FRAMES):
            js.process_frame(frames[i], dets[i])
            ps.process_frame(frames[i], dets[i])
            assert ps.running == js.running, i
            assert ps.sync_groups == js.sync_groups, i
            assert ps.map_good == js.map_good and ps._bad_streak == js._bad_streak
            for c in range(2):
                np.testing.assert_allclose(n(ps.trackers[c].pose.t),
                                           np.asarray(js.trackers[c].pose.t), atol=POSE_TOL)
                np.testing.assert_allclose(n(ps.trackers[c].pose.R),
                                           np.asarray(js.trackers[c].pose.R), atol=POSE_TOL)
            _assert_maps_agree(js.ms, ps.ms)
        assert ps.running == [True, True]
        assert sum(len(g) == 2 for g in ps.sync_groups) >= 2
        jcfb, pcfb = js.calib_init(), ps.calib_init()
        assert len(ps.groups) == len(js.groups)
        np.testing.assert_allclose(n(pcfb.R), np.asarray(jcfb.R), atol=POSE_TOL)
        np.testing.assert_allclose(n(pcfb.t), np.asarray(jcfb.t), atol=POSE_TOL)
        np.testing.assert_allclose(n(ps.group_bases.t), np.asarray(js.group_bases.t),
                                   atol=POSE_TOL)
        jst, pst = js.calib_step(5), ps.calib_step(5)
    np.testing.assert_allclose(n(ps.cam_from_base.R), np.asarray(js.cam_from_base.R),
                               atol=POSE_TOL)
    np.testing.assert_allclose(n(ps.cam_from_base.t), np.asarray(js.cam_from_base.t),
                               atol=POSE_TOL)
    assert float(pst.cost) == pytest.approx(float(jst.cost), rel=1e-4)


def test_init_from_calib_image_and_need_new_kf(scene):
    """The map bootstrap from camera 0's board view on frame 0, then the
    add heuristic for camera 0 at the poses of frames 0-3 and camera 1."""
    from mcptam_tpu.map.state import create_map_state as j_create
    from mcptam_tpu_torch.map.keyframe import make_frame_features
    from mcptam_tpu_torch.map.state import create_map_state

    cams, _, frames, dets = scene
    uv, bidx = dets[0][0]
    pose = base_pose(0)
    jms = j_create(H, W, 2, JSE3.identity((2,)), **CAPS)
    with jax_builder_drops_unplaced():
        jms, jidx, jslots = jpc.init_from_calib_image(
            jms, cams, j_features(jnp.asarray(frames[0], jnp.float32)), 0, uv,
            BOARD2[bidx], pose, return_slots=True)
    pcams = convert.camera_from_numpy(np_get(cams), device="cpu")
    pms = create_map_state(H, W, 2, SE3.identity((2,)), **CAPS)
    pms, pidx, pslots = ppc.init_from_calib_image(
        pms, pcams, make_frame_features(t(frames[0]).float()), 0, uv, BOARD2[bidx],
        SE3(R=t(pose.R), t=t(pose.t)), return_slots=True)
    assert int(pidx) == int(jidx)
    np.testing.assert_array_equal(n(pslots), np.asarray(jslots))
    _assert_maps_agree(jms, pms)
    np.testing.assert_array_equal(n(pms.points.pos_w), np.asarray(jms.points.pos_w))
    np.testing.assert_allclose(n(pms.points.center_nc), np.asarray(jms.points.center_nc),
                               atol=1e-6)
    np.testing.assert_allclose(n(pms.mkfs.scene_depth_mean),
                               np.asarray(jms.mkfs.scene_depth_mean), rtol=1e-5)
    for i in range(N_FRAMES):
        for c, dist in ((0, 0.05), (0, 0.02), (1, 0.05)):
            p = JSE3(R=jnp.eye(3), t=jnp.asarray([0.0, 0.0, 0.01 * c])) @ base_pose(i)
            depth = 1.7 - 0.01 * i
            want = bool(jpc.need_new_kf(jms, c, p, jnp.float32(depth), dist))
            got = bool(ppc.need_new_kf(pms, c, SE3(R=t(p.R), t=t(p.t)),
                                       t(np.float32(depth)), dist))
            assert got == want, (i, c, dist)


def test_base_shift_gn_matches_jax():
    """tests/test_pose_calib.py's shifted three-camera rig."""
    rng = np.random.default_rng(7)
    s_R = np.asarray(j_so3_exp(jnp.asarray([0.03, -0.05, 0.02], jnp.float32)), np.float64)
    s_t = np.array([0.04, -0.02, 0.06])
    rel, cfb = [(np.eye(3), np.zeros(3))], {}
    for c in range(3):
        if c == 0:
            R_rel, t_rel = np.eye(3), np.zeros(3)
        else:
            R_rel = np.asarray(j_so3_exp(jnp.asarray(rng.normal(size=3) * 0.4, jnp.float32)),
                               np.float64)
            t_rel = rng.normal(size=3) * 0.3
            rel.append((R_rel, t_rel))
        cfb[c] = (R_rel @ s_R.T, R_rel @ (-s_R.T @ s_t) + t_rel)
    want = jpc._base_shift_gn(cfb, rel, iters=10)
    got = ppc._base_shift_gn(cfb, rel, iters=10)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_allclose(got[0], s_R, atol=0.02)     # the JAX test's bar
    np.testing.assert_allclose(got[1], s_t, atol=0.02)
