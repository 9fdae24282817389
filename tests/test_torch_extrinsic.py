"""Port parity of extrinsic rig calibration (calib/extrinsic.py), the
bundle LM path for problems without an observation table
(ba/bundle.py: ``_solve_delta``, ``lm_step``, ``lm_run``) and the
calibration problem builders (ba/adjusters.py: ``problem_single``,
``problem_calib``) against the JAX package.

Tolerances: board PnP, host float64 numpy on both sides, 1e-9; the table-
less Gauss-Newton solve against JAX's and against the port's own
observation-table solve (``_solve_delta_soa``) at tests/test_bundle.py's
bar for two float32 assemblies of the same solve (2e-3 relative; 2e-5
absolute on the poses, 1e-3 on the points: the problem's near-scale gauge
amplifies assembly noise); the table-less LM's cost 1e-5 relative after 1
and 6 steps, and after one step its state within 2e-4 with the same
accept: later steps wander along that gauge at noise level, costs
agreeing, as that test notes; calibrate_rig's extrinsics and base poses
1e-4, and tests/test_extrinsic.py's gates; the problem builders' masks
and arrays exact; the pose_calibrator app's extrinsic 1e-3 of the JAX
app's (its LM's last accepts are at noise level) and tests/test_apps.py's
gates."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import jax_map, mapping_scene, n, np_get, t
from test_bundle import build_problem
from test_extrinsic import PARAMS, TRUE_REL, H, W, make_obs

from mcptam_tpu.ba import adjusters as ja
from mcptam_tpu.ba import bundle as jb
from mcptam_tpu.calib import extrinsic as jext
from mcptam_tpu.config import DEFAULT_BUNDLE as J_DEFAULT_BUNDLE
from mcptam_tpu_torch import convert
from mcptam_tpu_torch.ba import adjusters as pa
from mcptam_tpu_torch.ba import bundle as pb
from mcptam_tpu_torch.calib import extrinsic as pext
from mcptam_tpu_torch.config import DEFAULT_BUNDLE
from mcptam_tpu_torch.core.se3 import SE3

HOST_TOL, RIG_TOL = 1e-9, 1e-4
DELTA_RTOL, DELTA_ATOL = 2e-3, (2e-5, 2e-5, 1e-3)     # pose_a, pose_b, points


@pytest.fixture(scope="module")
def obs():
    """tests/test_extrinsic.py's shared-board observations (rng 42)."""
    return make_obs(np.random.default_rng(42))


def test_board_pose_pnp_matches_jax(obs):
    _, observations, board2, _ = obs
    for key in [(0, 0), (2, 1), (4, 0)]:
        o = observations[key]
        want = jext.board_pose_pnp(PARAMS, board2[o["board_idx"]], o["uv"], (W, H))
        got = pext.board_pose_pnp(PARAMS, board2[o["board_idx"]], o["uv"], (W, H))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=HOST_TOL, atol=HOST_TOL)


def test_average_relative_poses_matches_jax():
    rng = np.random.default_rng(3)
    R0 = np.asarray(jax.device_get(jext.so3_exp(jnp.asarray([0.1, 0.3, -0.2]))))
    rels = []
    for _ in range(5):
        dR = np.asarray(jax.device_get(jext.so3_exp(jnp.asarray(rng.normal(size=3) * 0.02,
                                                                jnp.float32))))
        rels.append((dR @ R0, rng.normal(size=3)))
    jR, jt = jext.average_relative_poses(rels)
    R, tt = pext.average_relative_poses(rels, device="cpu")
    np.testing.assert_allclose(R, jR, atol=1e-6)
    np.testing.assert_allclose(tt, jt, atol=1e-6)


def test_calibrate_rig_matches_jax(obs):
    jcams, observations, board2, _ = obs
    jcfb, jbase, _ = jext.calibrate_rig([PARAMS, PARAMS], observations, board2, (W, H),
                                        jcams)
    pcams = convert.camera_from_numpy(np_get(jcams), device="cpu")
    cfb, base, st = pext.calibrate_rig([PARAMS, PARAMS], observations, board2, (W, H),
                                       pcams)
    np.testing.assert_allclose(n(cfb.R), np.asarray(jcfb.R), atol=RIG_TOL)
    np.testing.assert_allclose(n(cfb.t), np.asarray(jcfb.t), atol=RIG_TOL)
    np.testing.assert_allclose(n(base.R), np.asarray(jbase.R), atol=RIG_TOL)
    np.testing.assert_allclose(n(base.t), np.asarray(jbase.t), atol=RIG_TOL)
    # tests/test_extrinsic.py's gates
    true = SE3(R=t(TRUE_REL.R), t=t(TRUE_REL.t))
    err = n((cfb[1] @ true.inv()).ln())
    assert np.linalg.norm(err[3:]) < 0.005, err
    assert np.linalg.norm(err[:3]) < 0.01, err


@pytest.fixture(scope="module")
def tableless():
    """tests/test_bundle.py's 4-pose, 2-camera problem with movable
    extrinsics and a fifth of its measurements invalid (rng 7), in both
    packages, without an observation table."""
    rng = np.random.default_rng(7)
    jprob, jcams, _, _, _ = build_problem(rng, n_poses=4, n_points=96, n_cams=2,
                                          noise_px=0.3, movable_b=True)
    mv = np.asarray(jprob.m_valid).copy()
    mv[rng.choice(len(mv), len(mv) // 5, replace=False)] = False
    jprob = jprob.replace(m_valid=jnp.asarray(mv))
    pprob = convert.bundle_problem_from_numpy(np_get(jprob), device="cpu")
    pcams = convert.camera_from_numpy(np_get(jcams), device="cpu")
    assert pprob.obs_idx is None
    return jprob, jcams, pprob, pcams


def _deltas(mod, prob, cams, bcfg):
    st = mod.create_lm_state(prob)
    e, Ja, Jb, Jl, ok = mod._residuals_and_jacobians(prob, st.pose_a, st.pose_b,
                                                     st.points, cams)
    w, _, _ = mod._robust(e, ok, bcfg)
    return st, w, mod._solve_delta(prob, e, Ja, Jb, Jl, w, st.lam)


def test_solve_delta_tableless_matches_jax(tableless):
    jprob, jcams, pprob, pcams = tableless
    _, _, want = _deltas(jb, jprob, jcams, J_DEFAULT_BUNDLE)
    _, _, got = _deltas(pb, pprob, pcams, DEFAULT_BUNDLE)
    for g_, w_, atol in zip(got, want, DELTA_ATOL):
        np.testing.assert_allclose(n(g_), np.asarray(w_), rtol=DELTA_RTOL, atol=atol)


def test_solve_delta_tableless_matches_soa(tableless):
    """The scatter solve and the observation-table (SoA) solve of the same
    problem, tests/test_bundle.py::test_soa_movable_b_matches_scatter_solve
    in the port."""
    _, _, pprob, pcams = tableless
    st, w, (da1, db1, dl1) = _deltas(pb, pprob, pcams, DEFAULT_BUNDLE)
    g = pb.attach_obs_table(pprob, D=4 * 2 + 2)
    da2, db2, dl2 = pb._solve_delta_soa(g, pb._soa_prep(g), st.pose_a, st.pose_b,
                                        st.points, pcams, w, st.lam)
    for a, b, atol in zip((da2, db2, dl2), (da1, db1, dl1), DELTA_ATOL):
        np.testing.assert_allclose(n(a), n(b), rtol=DELTA_RTOL, atol=atol)


@pytest.mark.parametrize("steps", [1, 6])
def test_lm_run_tableless_matches_jax(tableless, steps):
    """lm_step and lm_run on the table-less path against JAX's lm_run."""
    jprob, jcams, pprob, pcams = tableless
    jst = jb.lm_run(jprob, jb.create_lm_state(jprob), jcams, steps)
    pst = (pb.lm_step(pprob, pb.create_lm_state(pprob), pcams) if steps == 1
           else pb.lm_run(pprob, pb.create_lm_state(pprob), pcams, steps))
    assert float(pst.cost) == pytest.approx(float(jst.cost), rel=1e-5)
    assert int(pst.accepted) >= 1
    if steps == 1:
        assert int(pst.accepted) == int(jst.accepted)
        for a, b in ((pst.pose_a.t, jst.pose_a.t), (pst.pose_b.t, jst.pose_b.t),
                     (pst.pose_b.R, jst.pose_b.R), (pst.points, jst.points)):
            np.testing.assert_allclose(n(a), np.asarray(b), rtol=0, atol=2e-4)


@pytest.fixture(scope="module")
def mapping():
    """The map-maker tests' scene with its three keyframes integrated by
    the port (four MKFs, points with several measurements), as the port's
    and the JAX MapState (tests/test_torch_adjusters.py's scene)."""
    from _torch_parity import MKF_TANGENTS
    from mcptam_tpu_torch.map.mapmaker_core import integrate_mkf

    jcams, _, ms_np, feats = mapping_scene()
    pcams = convert.camera_from_numpy(np_get(jcams), device="cpu")
    ms = convert.map_state_from_numpy(ms_np, device="cpu")
    for v, f in zip(MKF_TANGENTS, feats):
        ms, _, ok = integrate_mkf(ms, pcams, convert.frame_features_from_numpy(f, device="cpu"),
                                  SE3.exp(t(v)))
        assert ok
    return jax_map(convert.to_numpy(ms)), ms


@pytest.mark.parametrize("kind", ["single", "calib"])
def test_calibration_problems_match(mapping, kind):
    """problem_single / problem_calib masks and arrays, exact."""
    jms, pms = mapping
    jfn, pfn = {"single": (ja.problem_single, pa.problem_single),
                "calib": (ja.problem_calib, pa.problem_calib)}[kind]
    jprob, pprob = jfn(jms), pfn(pms)
    p, j = convert.to_numpy(pprob), np_get(jprob)
    for key in ("movable_a", "movable_b", "movable_pt", "m_valid", "m_pose_a",
                "m_pose_b", "m_point", "m_uv", "m_level"):
        np.testing.assert_array_equal(p[key], np.asarray(getattr(j, key)), err_msg=key)
    assert p["movable_pt"].sum() > 20
    if kind == "single":
        # every valid MKF moves, the first included: the board pins the gauge
        np.testing.assert_array_equal(p["movable_a"], n(pms.mkfs.valid & ~pms.mkfs.fixed))
    else:
        assert not p["movable_b"][0] and p["movable_b"][1:].all()


def test_pose_calibrator_app_cpu(tmp_path, capsys):
    """The app's default (shared-board) path with --device cpu on
    tests/test_apps.py's 2-camera video, against the JAX app on the same
    files, and that test's gates."""
    from test_calib import board_pose

    from mcptam_tpu.apps.pose_calibrator import main as j_main
    from mcptam_tpu.calib.board import render_checkerboard
    from mcptam_tpu.core.camera import make_camera as j_make_camera
    from mcptam_tpu.core.se3 import SE3 as JSE3, so3_exp as j_so3_exp
    from mcptam_tpu_torch.apps.pose_calibrator import main

    true = np.array([95.0, -0.0045, 3.0e-6, -6.0e-9, 163.0, 122.0, 1.0, 0.0, 0.0])
    true_rel = JSE3(R=j_so3_exp(jnp.asarray([0.02, 0.30, -0.03])),
                    t=jnp.asarray([-0.20, 0.02, 0.05]))
    h, w = 240, 320
    cam = j_make_camera(true, (w, h))
    rig = str(tmp_path / "rig.json")
    with open(rig, "w") as f:
        json.dump({"width": w, "height": h, "cameras": [
            {"name": f"camera{c + 1}", "params": [float(x) for x in true]}
            for c in range(2)]}, f)
    frames = np.zeros((2, 6, h, w), np.uint8)
    for i in range(6):
        bfc0 = board_pose(i)
        frames[0, i] = np.asarray(render_checkerboard(cam, bfc0, h, w, (8, 6), 0.04))
        frames[1, i] = np.asarray(render_checkerboard(cam, bfc0 @ true_rel.inv(), h, w,
                                                      (8, 6), 0.04))
    video = str(tmp_path / "views.npz")
    np.savez(video, frames=frames)
    args = ["--rig", rig, "--video", video, "--squares", "8x6", "--square-size", "0.04"]
    assert main(args + ["--out", str(tmp_path / "port.json"), "--device", "cpu"]) == 0
    assert "falling back" not in capsys.readouterr().out
    assert j_main(args + ["--out", str(tmp_path / "jax.json"), "--platform", "cpu"]) == 0
    with open(tmp_path / "port.json") as f:
        got = np.asarray(json.load(f)["cameras"][1]["cam_from_base"])
    with open(tmp_path / "jax.json") as f:
        want = np.asarray(json.load(f)["cameras"][1]["cam_from_base"])
    np.testing.assert_allclose(got, want, atol=1e-3)
    rel = SE3.exp(t(got).float())
    err = n((rel @ SE3(R=t(true_rel.R), t=t(true_rel.t)).inv()).ln())
    assert np.linalg.norm(err[3:]) < 0.02, err
    assert np.linalg.norm(err[:3]) < 0.03, err
