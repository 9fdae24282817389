"""Port parity of the live session: System.process_frame from an empty map
(bootstrap on the first frame, tracking, keyframe adds through the
MiniPatch candidate filter, the map-maker ticking every frame) against the
JAX System, frame by frame; then the live entry points on the port alone:
the failed-map dump, runtime variables, ManualAddMKF, checkpoint and
resume, and process_frames on an uninitialised system.

Both packages get the same uint8 frames along tests/test_system.py's
trajectory and its configuration.  The JAX builder's scatter fault
(ROADMAP section C) is repaired in this process, as in
tests/test_torch_mapmaker.py.  Tolerances: lost, quality, found count,
keyframe add, relocalisation, map counts and scheduler state exact; the
pose 1e-4 (rotation entries and metres, 20 Gauss-Newton iterations of f32
normal equations summed in another order, on a map whose stereo points
agree to ~1e-4 of their depth, tests/test_torch_bootstrap.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import C, H, W, jax_builder_drops_unplaced, jax_scene, np_get, t

from mcptam_tpu.config import MapMakerConfig as JMC, TrackerConfig as JTC
from mcptam_tpu.core.se3 import SE3 as JSE3
from mcptam_tpu.io.synthetic import render_rig as j_render_rig
from mcptam_tpu.system.system import System as JSystem
from mcptam_tpu_torch import convert
from mcptam_tpu_torch.config import MapMakerConfig as PMC, TrackerConfig as PTC
from mcptam_tpu_torch.system.mapmaker import MM_INITIALIZING, MM_RUNNING
from mcptam_tpu_torch.system.system import System

TCFG = dict(max_patches_per_frame=200, coarse_max=20, coarse_min=6)
MCFG = dict(init_depth=5.0, max_scaled_mkf_dist=0.04)
CAPS = dict(max_points=2048, max_mkfs=8, max_meas=8192)
N_FRAMES = 5


def _tangent(i):
    return np.array([0.05 * i, 0.0, 0.03 * i, 0.0, 0.02 * i, 0.0], np.float32)


@pytest.fixture(scope="module")
def frames():
    cams, cfb, _, _, _ = jax_scene()
    return np.stack([np.asarray(jnp.clip(j_render_rig(
        cams, cfb, JSE3.exp(jnp.asarray(_tangent(i))), 3.0, H, W), 0, 255)).astype(np.uint8)
        for i in range(N_FRAMES + 3)])


def _port_system(**kw):
    cams, cfb, cams_sbi, _, _ = jax_scene()
    return System(convert.camera_from_numpy(np_get(cams), device="cpu"),
                  convert.se3_from_numpy(np_get(cfb), device="cpu"),
                  convert.camera_from_numpy(np_get(cams_sbi), device="cpu"),
                  H, W, PTC(**TCFG), PMC(**MCFG), **CAPS, **kw)


@pytest.fixture(scope="module")
def sessions(frames):
    cams, cfb, cams_sbi, _, _ = jax_scene()
    jsys = JSystem(cams, cfb, cams_sbi, H, W, JTC(**TCFG), JMC(**MCFG), **CAPS)
    psys = _port_system()
    with jax_builder_drops_unplaced():
        jinfos = [jsys.process_frame(jnp.asarray(f, jnp.float32)) for f in frames[:N_FRAMES]]
    pinfos = [psys.process_frame(t(f)) for f in frames[:N_FRAMES]]
    return jsys, jinfos, psys, pinfos


def test_live_session_matches(sessions):
    jsys, jinfos, psys, pinfos = sessions
    assert psys.initialized and jsys.initialized
    assert [i.frame_id for i in pinfos] == [i.frame_id for i in jinfos] == list(range(N_FRAMES))
    for pi, ji in zip(pinfos, jinfos):
        for name in ("lost", "quality", "n_found", "added_mkf", "relocalized",
                     "n_points", "n_mkfs", "mm_state", "provisional"):
            assert getattr(pi, name) == getattr(ji, name), (ji.frame_id, name)
        np.testing.assert_allclose(pi.pose, ji.pose, rtol=0, atol=1e-4)
    assert any(i.added_mkf for i in pinfos)
    assert not pinfos[-1].lost and pinfos[-1].n_points > 50
    err_t = np.linalg.norm(pinfos[-1].pose[:, 3] - _tangent(N_FRAMES - 1)[:3])
    assert err_t < 0.06, err_t


def test_live_session_map_matches(sessions):
    jsys, _, psys, _ = sessions
    j, p = np_get(jsys.ms), convert.to_numpy(psys.ms)
    for group, names in (("points", ("valid", "src_mkf", "src_cam", "src_level")),
                         ("mkfs", ("valid", "fixed", "kf_valid", "seq")),
                         ("meas", ("valid", "source", "point", "mkf"))):
        for name in names:
            np.testing.assert_array_equal(p[group][name], getattr(getattr(j, group), name),
                                          err_msg=f"{group}.{name}")
    np.testing.assert_allclose(p["mkfs"]["base_from_world"]["t"],
                               j.mkfs.base_from_world.t, rtol=0, atol=1e-4)
    for name in ("_ba_kind", "_local_done", "_global_done", "state"):
        assert getattr(psys.mapmaker, name) == getattr(jsys.mapmaker, name), name


def test_failed_ba_dumps_map_and_resets(frames, tmp_path):
    """Repeated BA failure: the map is dumped, then a reset that keeps the
    pose; the next frame bootstraps again."""
    import dataclasses
    sys_ = _port_system()
    sys_.process_frame(t(frames[0]))
    path = str(tmp_path / "fail_map.dat")
    sys_.mcfg = dataclasses.replace(sys_.mcfg, fail_dump_path=path)
    sys_.mapmaker.failed_ba_count = sys_.mcfg.max_consecutive_failed_ba
    # park the BA schedule: a successful BA would clear the failure count
    sys_.mapmaker._reset_ba()
    sys_.mapmaker._local_done = sys_.mapmaker._global_done = True
    info = sys_.process_frame(t(frames[0]))
    assert os.path.exists(path)
    assert "% mcptam_tpu map dump" in open(path).read()
    assert not sys_.initialized and int(sys_.ms.points.valid.sum()) == 0
    np.testing.assert_array_equal(sys_.ts.pose.t.numpy(), info.pose[:, 3])
    assert sys_.process_frame(t(frames[0])).n_points > 50 and sys_.initialized


def test_runtime_vars_and_manual_add(frames):
    sys_ = _port_system()
    sys_.process_frame(t(frames[0]))
    assert sys_.mapmaker.state == MM_INITIALIZING
    # GlareMasking masks the next frames' features
    sys_.set_var("GlareMasking", True)
    img = frames[1].copy()
    img[:, 40:90, 60:160] = 255
    assert int(sys_._features(t(img)).corner_counts.sum()) < \
        int(_port_system()._features(t(img)).corner_counts.sum())
    sys_.set_var("GlareMasking", False)
    # the point-creation policy flows into the map-maker's configuration
    sys_.set_var("LevelZeroPoints", False)
    assert sys_.mapmaker.mcfg.level_zero_points is False and sys_.get_var("LevelZeroPoints") is False
    sys_.set_var("CrossCamera", False)
    assert sys_.mapmaker.mcfg.cross_camera is False
    with pytest.raises(KeyError):
        sys_.set_var("NoSuchVar", 1)
    # AddingMKFs off: no add, even far from the map's keyframe
    sys_.set_var("AddingMKFs", False)
    assert not sys_.process_frame(t(frames[4])).added_mkf
    # ManualAddMKF ends initialisation, then forces the next add
    sys_.manual_add_mkf()
    assert sys_.mapmaker.state == MM_RUNNING
    sys_.manual_add_mkf()
    assert sys_.process_frame(t(frames[4])).added_mkf
    assert not sys_._force_add_next


def test_checkpoint_resume_continues_tracking(frames, tmp_path):
    """A new System restores a saved session and keeps tracking without
    bootstrapping again."""
    a = _port_system()
    for f in frames[:4]:
        info = a.process_frame(t(f))
    assert not info.lost
    path = str(tmp_path / "session.npz")
    a.save(path)
    b = _port_system()
    b.load(path)
    assert b.initialized and b.mapmaker.state == a.mapmaker.state
    assert int(b.ms.points.valid.sum()) == int(a.ms.points.valid.sum())
    torch.testing.assert_close(b.ts.pose.t, a.ts.pose.t, rtol=0, atol=0)
    for i in range(4, 7):
        info = b.process_frame(t(frames[i]))
        assert not info.lost
    err_t = np.linalg.norm(info.pose[:, 3] - _tangent(6)[:3])
    assert err_t < 0.06, err_t
    assert info.n_mkfs >= 2


def test_process_frames_bootstraps_an_empty_map(frames):
    """process_frames on an uninitialised system takes its frames one by
    one through process_frame, which bootstraps the map."""
    sys_ = _port_system(pipeline_depth=0)
    out = sys_.process_frames(t(frames[:2]))
    assert sys_.initialized
    assert [i.frame_id for i in out] == [0, 1] and not any(i.lost for i in out)
    out = sys_.process_frames(t(frames[2:4]))      # now the batched path
    assert [i.frame_id for i in out] == [2, 3] and not any(i.lost for i in out)
