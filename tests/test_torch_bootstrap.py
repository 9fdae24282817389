"""Port parity of the map bootstrap (map/mapmaker_core.py::init_from_mkf,
system/mapmaker.py::MapMaker.init) and of map I/O (system/mapio.py).

init_from_mkf runs on the JAX features of the scene's first frame in both
packages.  The JAX builder's scatter fault (ROADMAP section C) is repaired
in this process, as in tests/test_torch_mapmaker.py.  Tolerances: created
points, slots, measurements and every integer and flag of the map exact;
the rest of the float state within 1e-4.  Point positions and their
pixel footprint vectors (which scale with them) are held to their depth:
90% within 1e-4 of it and all within 5e-4.  The rays agree to 2e-7, but
the stereo points come out of the midpoint triangulation, whose
1 - cos^2(parallax) cancels digits in f32 (measured here: 5 of 84 points
between 1.1e-4 and 2.2e-4 of their depth).  Map files: leaf for leaf, bit for bit, in both directions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import (
    C, H, MAX_MEAS, MAX_MKFS, MAX_POINTS, W, jax_builder_drops_unplaced, jax_scene,
    n, np_get, port_scene, t,
)

from mcptam_tpu.config import MapMakerConfig as JMC
from mcptam_tpu.core.se3 import SE3 as JSE3
from mcptam_tpu.io.synthetic import make_rig as j_make_rig, render_rig as j_render_rig
from mcptam_tpu.map import mapmaker_core as jmc
from mcptam_tpu.map.keyframe import make_frame_features as j_features
from mcptam_tpu.map.state import create_map_state as j_create
from mcptam_tpu.system import mapio as jmapio
from mcptam_tpu.system.mapmaker import MapMaker as JMapMaker
from mcptam_tpu_torch import convert
from mcptam_tpu_torch.config import MapMakerConfig as PMC
from mcptam_tpu_torch.core.se3 import SE3
from mcptam_tpu_torch.map import mapmaker_core as pmc
from mcptam_tpu_torch.map.state import create_map_state as p_create
from mcptam_tpu_torch.system import mapio as pmapio
from mcptam_tpu_torch.system.mapmaker import MapMaker

POINT_FLOATS = ("pos_w", "pixel_right_w", "pixel_down_w")


@pytest.fixture(autouse=True, scope="module")
def _repaired_jax_builder():
    with jax_builder_drops_unplaced():
        yield


def _scene(n_cams):
    """JAX cams, cam_from_base and the first frame's JAX features (numpy)
    for a rig of n_cams cameras of the parity scene's size."""
    if n_cams == C:
        cams, cfb, _, _, frames = jax_scene()
        img = frames[0]
    else:
        cams, cfb = j_make_rig(n_cams, H, W, spread_deg=25.0)
        img = np.asarray(jnp.clip(j_render_rig(cams, cfb, JSE3.identity(), 3.0, H, W),
                                  0, 255)).astype(np.uint8)
    feats = np_get(jax.jit(j_features)(jnp.asarray(img, jnp.float32)))
    return cams, cfb, feats


def _cmp_map(p, j, depth=None):
    """Port map (numpy tree) against the JAX map; ``depth`` (N,) scales the
    point rows."""
    for key, val in p.items():
        ref = getattr(j, key)
        if isinstance(val, dict):
            _cmp_map(val, ref, depth)
        elif val.dtype.kind != "f":
            np.testing.assert_array_equal(val, np.asarray(ref), err_msg=key)
        elif key in POINT_FLOATS:
            ref = np.asarray(ref)
            rel = np.abs(val - ref).max(-1) / np.maximum(depth, 1e-6)
            if key != "pos_w":      # footprints: one pixel at the point's depth
                rel = rel * depth / np.maximum(np.abs(ref).max(-1), 1e-9)
            assert (rel <= 5e-4).all(), (key, rel.max())
            assert (rel <= 1e-4).mean() >= 0.9, (key, np.sort(rel)[-10:])
        else:
            np.testing.assert_allclose(val, np.asarray(ref), rtol=1e-4, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("n_cams", [C, 1])
def test_init_from_mkf_matches(n_cams):
    """Stereo init into camera (c+1) % C for a rig, fixed-depth points for
    one camera; the first MKF is fixed."""
    cams, cfb, feats = _scene(n_cams)
    mcfg = dict(init_depth=5.0)
    jms = j_create(H, W, n_cams, cfb, MAX_POINTS, MAX_MKFS, MAX_MEAS)
    jms, jidx = jax.jit(lambda ms, f: jmc.init_from_mkf(ms, cams, f, JSE3.identity(),
                                                        JMC(**mcfg)))(
        jms, jax.tree_util.tree_map(jnp.asarray, feats))
    pcams = convert.camera_from_numpy(np_get(cams), device="cpu")
    pms = p_create(H, W, n_cams, convert.se3_from_numpy(np_get(cfb), device="cpu"),
                   MAX_POINTS, MAX_MKFS, MAX_MEAS)
    pms, pidx = pmc.init_from_mkf(pms, pcams, convert.frame_features_from_numpy(feats, device="cpu"),
                                  SE3.identity(device="cpu"), PMC(**mcfg))
    j, p = np_get(jms), convert.to_numpy(pms)
    assert int(pidx) == int(jidx) == 0
    n_pts = int(p["points"]["valid"].sum())
    assert n_pts == int(j.points.valid.sum()) > 50
    assert bool(p["mkfs"]["fixed"][0]) and bool(j.mkfs.fixed[0])
    if n_cams == 1:
        # every point lies at init_depth along its ray
        cam_pos = -np.asarray(cfb.R[0]).T @ np.asarray(cfb.t[0])
        d = np.linalg.norm(p["points"]["pos_w"][p["points"]["valid"]] - cam_pos, axis=-1)
        np.testing.assert_allclose(d, 5.0, rtol=1e-5)
    else:
        assert (p["meas"]["source"][p["meas"]["valid"]] == 4).sum() == n_pts  # SRC_EPIPOLAR
    cam_pos = -np.einsum("cji,cj->ci", np.asarray(cfb.R), np.asarray(cfb.t))
    src = np.asarray(j.points.src_cam)
    depth = np.linalg.norm(np.asarray(j.points.pos_w) - cam_pos[src], axis=-1)
    _cmp_map(p, j, np.where(np.asarray(j.points.valid), depth, 1.0))


def test_mapmaker_init_fails_below_min_points():
    """Too few points: init fails and leaves the map untouched, in both
    packages, and the scheduler keeps its state; at the default threshold
    the port's init succeeds and starts MM_INITIALIZING."""
    cams, cfb, feats = _scene(C)
    pcams = convert.camera_from_numpy(np_get(cams), device="cpu")
    pcfb = convert.se3_from_numpy(np_get(cfb), device="cpu")
    pfeats = convert.frame_features_from_numpy(feats, device="cpu")
    jmm = JMapMaker(cams=cams, mcfg=JMC(min_map_points=100000))
    pmm = MapMaker(cams=pcams, mcfg=PMC(min_map_points=100000))
    jmm.state = pmm.state = 1
    jms0 = j_create(H, W, C, cfb, MAX_POINTS, MAX_MKFS, MAX_MEAS)
    pms0 = p_create(H, W, C, pcfb, MAX_POINTS, MAX_MKFS, MAX_MEAS)
    jms, jok = jmm.init(jms0, jax.tree_util.tree_map(jnp.asarray, feats), JSE3.identity())
    pms, pok = pmm.init(pms0, pfeats, SE3.identity(device="cpu"))
    assert pok is jok is False
    assert pmm.state == jmm.state == 1
    assert pms is pms0
    assert int(pms.points.valid.sum()) == 0 and int(pms.mkfs.valid.sum()) == 0
    assert int(jnp.sum(jms.points.valid)) == 0 and int(jnp.sum(jms.mkfs.valid)) == 0

    pmm = MapMaker(cams=pcams, mcfg=PMC())
    pmm.state = 1
    pms, pok = pmm.init(pms0, pfeats, SE3.identity(device="cpu"))
    assert pok and pmm.state == 0 and int(pms.points.valid.sum()) >= PMC().min_map_points
    assert int(pms0.points.valid.sum()) == 0          # init ran on a copy


def test_map_leaf_table_is_the_jax_flatten_order():
    _, _, _, ms, _ = jax_scene()
    paths = [".".join(k.name for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(ms)[0]]
    assert tuple(paths) == pmapio.MAP_LEAVES


def test_map_files_cross_read(tmp_path):
    """The port's save_map is read by the JAX load_map and the other way
    round, leaf for leaf; extras travel too."""
    _, _, _, jms, _ = jax_scene()
    pms = port_scene()[3]
    pms.points.pos_w[0, 0] += 0.5          # the two maps differ
    extras = {"pose_t": np.arange(3, dtype=np.float32), "initialized": np.bool_(True)}

    pmapio.save_map(str(tmp_path / "p.npz"), pms, extras=extras)
    got, ex = jmapio.load_map(str(tmp_path / "p.npz"), jms, with_extras=True)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            _port_leaves(pms)):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    np.testing.assert_array_equal(ex["pose_t"], extras["pose_t"])

    jmapio.save_map(str(tmp_path / "j.npz"), jms, extras=extras)
    back, ex = pmapio.load_map(str(tmp_path / "j.npz"), pms, with_extras=True)
    for a, b in zip(_port_leaves(back), jax.tree_util.tree_leaves(np_get(jms))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert bool(ex["initialized"])
    assert back.points.pos_w.device == pms.points.pos_w.device


def _port_leaves(ms):
    out = []
    for name in pmapio.MAP_LEAVES:
        obj = ms
        for part in name.split("."):
            obj = getattr(obj, part)
        out.append(n(obj))
    return out


def test_ascii_dumps_match(tmp_path):
    cams, cfb, _, jms, _ = jax_scene()
    pcams, pcfb, _, pms, _ = port_scene()
    jmapio.dump_map_ascii(str(tmp_path / "j.dat"), jms)
    pmapio.dump_map_ascii(str(tmp_path / "p.dat"), pms)
    assert (tmp_path / "p.dat").read_text() == (tmp_path / "j.dat").read_text()
    jmapio.dump_cameras_ascii(str(tmp_path / "jc.dat"), cams, cfb, H, W)
    pmapio.dump_cameras_ascii(str(tmp_path / "pc.dat"), pcams, pcfb, H, W)
    assert (tmp_path / "pc.dat").read_text() == (tmp_path / "jc.dat").read_text()
