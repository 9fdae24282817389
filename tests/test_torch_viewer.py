"""Port parity of the headless viewer (system/viewer.py) and of the System
members the app and the GUI console call: parse_line, profile_frame,
small_image, keyframe_view, rescale_map and align_to_dominant_plane.

The viewer functions get one map and one frame's features from the port,
converted for the JAX package, and must write the same bytes: keyframe
overlays, the tiled monitor image, the keyframe dump and the PLY text.
The System members run on a port System over tests/test_system.py's
configuration and trajectory; profile_frame must end in the pose that
process_frame gives from the same state, within 1e-5."""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_tree_from_numpy, synthetic_track_result

from mcptam_tpu.core.se3 import SE3 as JSE3
from mcptam_tpu.map.state import create_map_state as j_create_map_state
from mcptam_tpu.system import viewer as jviewer
from mcptam_tpu_torch import convert
from mcptam_tpu_torch.config import MapMakerConfig, TrackerConfig
from mcptam_tpu_torch.core.se3 import SE3
from mcptam_tpu_torch.io.synthetic import (
    build_groundtruth_map, make_rig, make_sbi_cams, render_rig,
)
from mcptam_tpu_torch.map.keyframe import make_frame_features
from mcptam_tpu_torch.map.state import clone_tree, kf_cam_from_world
from mcptam_tpu_torch.system import viewer as pviewer
from mcptam_tpu_torch.system.mapmaker import MM_INITIALIZING, MM_RUNNING
from mcptam_tpu_torch.system.system import System

H, W, C = 240, 320, 2
SEED = 3.0
TCFG = dict(max_patches_per_frame=200, coarse_max=20, coarse_min=6)
MCFG = dict(init_depth=5.0, max_scaled_mkf_dist=0.04)
CAPS = dict(max_points=2048, max_mkfs=8, max_meas=8192)
POSE_TOL = 1e-5


def _tangent(i):
    return np.array([0.05 * i, 0.0, 0.03 * i, 0.0, 0.02 * i, 0.0], np.float32)


@pytest.fixture(scope="module")
def rig():
    cams, cfb = make_rig(C, H, W, spread_deg=25.0, device="cpu")
    return cams, cfb


@pytest.fixture(scope="module")
def frames(rig):
    cams, cfb = rig
    return [torch.clamp(render_rig(cams, cfb, SE3.exp(torch.as_tensor(_tangent(i))),
                                   SEED, H, W), 0, 255).to(torch.uint8) for i in range(6)]


@pytest.fixture(scope="module")
def scene(rig, frames):
    """The port's ground-truth map with a few bad points, the same map as
    a JAX MapState, the features of frame 1 and a tracker result."""
    cams, cfb = rig
    ms, _ = build_groundtruth_map(cams, cfb, H, W, n_per_level=12, max_points=256,
                                  max_mkfs=4, max_meas=1024)
    ms.points.bad[::7] = True
    ms_np = convert.to_numpy(ms)
    jcfb = JSE3(R=jnp.asarray(ms_np["cam_from_base"]["R"]), t=jnp.asarray(ms_np["cam_from_base"]["t"]))
    jms = jax_tree_from_numpy(j_create_map_state(H, W, C, jcfb, 256, 4, 1024), ms_np)
    feats = make_frame_features(frames[1])
    res = SimpleNamespace(**synthetic_track_result(ms_np, cams, _tangent(1), K=48))
    return ms, jms, feats, res


def test_write_ppm_matches(tmp_path, rng):
    rgb = rng.integers(0, 255, (10, 12, 3), dtype=np.uint8)
    pviewer.write_ppm(str(tmp_path / "p.ppm"), rgb)
    jviewer.write_ppm(str(tmp_path / "j.ppm"), rgb)
    assert open(tmp_path / "p.ppm", "rb").read() == open(tmp_path / "j.ppm", "rb").read()


@pytest.mark.parametrize("cam", [0, 1])
def test_keyframe_overlay_matches(scene, cam):
    ms, jms, _, _ = scene
    m = int(np.flatnonzero(ms.mkfs.valid.numpy())[0])
    got = pviewer.keyframe_overlay(ms, m, cam)
    assert got.shape == (H, W, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jviewer.keyframe_overlay(jms, m, cam))
    assert (got[..., 0] != got[..., 2]).any()     # measurements were drawn


@pytest.mark.parametrize("cams,level", [((0, 1), 0), ((0, 1), 2), ((0,), 1), ((0, 1, 0), 3)])
def test_frame_small_image_matches(scene, cams, level):
    _, _, feats, res = scene
    atlas = feats.atlas[list(cams)]
    got = pviewer.frame_small_image(SimpleNamespace(atlas=atlas), res, level)
    want = jviewer.frame_small_image(SimpleNamespace(atlas=atlas.numpy()), res, level)
    np.testing.assert_array_equal(got, want)
    cols = 2 if len(cams) > 1 else 1
    assert got.shape == (-(-len(cams) // cols) * (H >> level), cols * (W >> level), 3)
    np.testing.assert_array_equal(pviewer.frame_small_image(feats, None, level),
                                  jviewer.frame_small_image(
                                      SimpleNamespace(atlas=feats.atlas.numpy()), None, level))


def test_dump_keyframes_matches(scene, tmp_path):
    ms, jms, _, _ = scene
    paths = pviewer.dump_keyframes(ms, str(tmp_path / "p"))
    jpaths = jviewer.dump_keyframes(jms, str(tmp_path / "j"))
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in jpaths]
    assert len(paths) == int(ms.mkfs.kf_valid[ms.mkfs.valid].sum())
    for p, j in zip(paths, jpaths):
        assert open(p, "rb").read() == open(j, "rb").read()


def test_export_ply_matches(scene, tmp_path, rng):
    ms, jms, _, _ = scene
    traj = rng.normal(size=(5, 3))
    n = pviewer.export_ply(str(tmp_path / "p.ply"), ms, trajectory=traj)
    jn = jviewer.export_ply(str(tmp_path / "j.ply"), jms, trajectory=traj)
    assert n == jn == int((ms.points.valid & ~ms.points.bad).sum()) + int(ms.mkfs.valid.sum()) + 5
    assert open(tmp_path / "p.ply").read() == open(tmp_path / "j.ply").read()


# -- System members ----------------------------------------------------------

def _system(rig):
    cams, cfb = rig
    return System(cams, cfb, make_sbi_cams(cams, H, W), H, W, TrackerConfig(**TCFG),
                  MapMakerConfig(**MCFG), **CAPS)


@pytest.fixture(scope="module")
def ran(rig, frames):
    sys_ = _system(rig)
    infos = [sys_.process_frame(f) for f in frames[:3]]
    assert not infos[-1].lost
    return sys_


def test_gui_command_console(rig, frames, tmp_path):
    """tests/test_system.py::test_gui_command_console's vocabulary on the
    port's System."""
    sys_ = _system(rig)
    for f in frames[:3]:
        info = sys_.process_frame(f)
    assert not info.lost

    sys_.parse_line("DrawLevel=1")
    assert sys_.get_var("DrawLevel") == 1
    assert sys_.small_image().shape == (H // 2, 2 * (W // 2), 3)
    sys_.parse_line("AddingMKFs=false")
    assert sys_.get_var("AddingMKFs") is False
    sys_.parse_line("AddingMKFs=true")
    sys_.parse_line("  ")                       # a blank line does nothing
    with pytest.raises(KeyError):
        sys_.parse_line("NoSuchVar=1")

    mp, cp = str(tmp_path / "map.dat"), str(tmp_path / "cameras.dat")
    sys_.parse_line(f"ExportMapToFile {mp} {cp}")
    assert "point" in open(mp).read()
    cam_lines = open(cp).read().splitlines()
    assert cam_lines[3] == str(sys_.n_cams)
    row = cam_lines[4].split(", ")
    assert row[1] == str(W) and row[2] == str(H) and float(row[6]) == 0.0
    assert len(row) >= 13 and cam_lines[-1] == "% The end"

    mask = sys_.ms.points.valid.numpy()
    before = sys_.ms.points.pos_w.numpy().copy()
    pose_t = sys_.ts.pose.t.clone()
    sys_.parse_line("ScaleMapUp")
    np.testing.assert_allclose(sys_.ms.points.pos_w.numpy()[mask], 2.0 * before[mask], rtol=1e-5)
    torch.testing.assert_close(sys_.ts.pose.t, 2.0 * pose_t)
    sys_.parse_line("ScaleMapDown")
    np.testing.assert_allclose(sys_.ms.points.pos_w.numpy()[mask], before[mask], rtol=1e-5)

    img0 = sys_.keyframe_view()
    sys_.parse_line("ShowNextKeyFrame")
    img1 = sys_.keyframe_view()
    assert img0 is not None and img0.shape == img1.shape == (H, W, 3)
    sys_.parse_line("ShowPrevKeyFrame")
    assert sys_._kf_view == 0

    if sys_.mapmaker.state == MM_INITIALIZING:
        sys_.parse_line("ManualAddMKF")
        assert sys_.mapmaker.state == MM_RUNNING
    sys_.parse_line("KeyPress a")               # the same as ManualAddMKF
    n_before = int(sys_.ms.mkfs.valid.sum())
    info = sys_.process_frame(frames[3])
    assert info.added_mkf and not sys_._force_add_next
    sys_.flush_pipeline()
    assert int(sys_.ms.mkfs.valid.sum()) > n_before

    sys_.parse_line("InitTracker")              # a running map: nothing happens
    assert sys_.initialized
    with pytest.raises(ValueError):
        sys_.parse_line("NoSuchCommand")
    sys_.parse_line("KeyPress q")
    assert sys_.done
    sys_.done = False
    sys_.parse_line("quit")
    assert sys_.done
    sys_.parse_line("Reset")
    assert not sys_.initialized and int(sys_.ms.points.valid.sum()) == 0


def test_profile_frame_matches_process_frame(rig, frames, ran):
    """Stage by stage from the same state as process_frame's fused step:
    the same pose, within 1e-5."""
    a = ran
    b = _system(rig)
    b.ms, b.ts, b.initialized = clone_tree(a.ms), clone_tree(a.ts), True
    timing = a.profile_frame(frames[3])
    info = b.process_frame(frames[3])
    np.testing.assert_allclose(a.ts.pose.R.numpy(), info.pose[:, :3], rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(a.ts.pose.t.numpy(), info.pose[:, 3], rtol=0, atol=POSE_TOL)
    stages = ("kf_downsample", "sbi", "motion", "pvs", "coarse", "fine", "pose", "depth", "add")
    assert all(getattr(timing, s) > 0 for s in stages)
    assert timing.total == pytest.approx(sum(getattr(timing, s) for s in stages))
    assert a.small_image(level=2).shape == (H // 4, 2 * (W // 4), 3)


@pytest.mark.parametrize("flatten", [False, True])
def test_align_keeps_camera_coordinates(rig, ran, flatten):
    """Aligning the world to the dominant plane moves points and poses
    together: every live point's coordinates in every valid keyframe
    camera and in the tracker's rig stay the same, plane found or not.
    The tracked map (points on the textured sphere) and the same map with
    its live points pressed onto the plane y = 0.3 (found: z = 0 after)."""
    sys_ = _system(rig)
    sys_.ms, sys_.ts, sys_.initialized = clone_tree(ran.ms), clone_tree(ran.ts), True
    live = (sys_.ms.points.valid & ~sys_.ms.points.bad).numpy()
    if flatten:
        sys_.ms.points.pos_w[torch.as_tensor(live), 1] = 0.3

    def cam_coords():
        kcw = kf_cam_from_world(sys_.ms)
        pos = sys_.ms.points.pos_w[live]
        kf = torch.einsum("mcij,nj->mcni", kcw.R, pos) + kcw.t[:, :, None]
        kf = kf[sys_.ms.mkfs.kf_valid]
        return kf.numpy(), sys_.ts.pose.apply(pos).numpy()

    kf0, rig0 = cam_coords()
    ok = sys_.align_to_dominant_plane(seed=0)
    kf1, rig1 = cam_coords()
    for x0, x1 in ((kf0, kf1), (rig0, rig1)):
        np.testing.assert_allclose(x1, x0, rtol=0, atol=1e-4 * np.abs(x0).max())
    assert ok == flatten
    if ok:
        assert np.abs(sys_.ms.points.pos_w.numpy()[live, 2]).max() < 1e-4


def test_load_clears_viewer_state(rig, ran, tmp_path):
    path = str(tmp_path / "s.npz")
    ran.save(path)
    b = _system(rig)
    b.process_frame(torch.zeros(C, H, W))
    b.done, b._kf_view = True, 3
    assert b._last_result is not None
    b.load(path)
    assert not b.done and b._kf_view == 0 and b._last_result is None
    assert b.small_image() is None
