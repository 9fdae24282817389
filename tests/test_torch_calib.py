"""Port parity of checkerboard detection and intrinsic calibration
(mcptam_tpu_torch/calib/{board,corners,intrinsic,intrinsic_gpu}.py and the
camera_calibrator app) against the JAX package, on tests/test_calib.py's
six 240x320 board views.

Tolerances: the rendered board 1e-3 grey levels and the projected corners
1e-3 px (the same float32 unprojection, summed in another order); the
X-corner response 1e-5 of its largest value; the refined corners 1e-3 px
with the same grid keys (near-tied responses may list corners in another
order, so the lists are compared sorted); the host numpy code (the linear
initialisation, the float64 LM) equal to 1e-9 relative, being the same
numpy operations; one device LM step from the same state: the normal
equation blocks 1e-4 of each block's largest entry (float32 sums of
Jacobians taken by forward-mode differentiation in another order), the
residuals 1e-4 px (a few float32 ulps of the ~300 px projections) and the
step 1e-3 of its largest entry (the 9x9 Schur system spans 16 decades);
the whole device LM against JAX's from the same initialisation: the RMS
within 1e-3 px and the projection function within 0.75 px over the
calibrated field of view, the JAX package's own bar between its float32
and float64 backends (tests/test_calib.py): the lens's affine terms lie in
a valley flat below float32 resolution, where the two LMs' accept and
reject decisions part after five iterations."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from test_calib import (
    H, SQ, SQUARES, TRUE_PARAMS, W, _grids_for_calib, board_pose,
)

from mcptam_tpu.calib import corners as jcorners, intrinsic as jintr
from mcptam_tpu.calib.board import project_corners as j_project_corners
from mcptam_tpu.calib.board import render_checkerboard as j_render
from mcptam_tpu.calib.intrinsic_tpu import refine_lm_tpu
from mcptam_tpu.core.camera import make_camera as j_make_camera
from mcptam_tpu.ops.fast import topk_corners as j_topk
from mcptam_tpu_torch.calib import corners, intrinsic
from mcptam_tpu_torch.calib.board import project_corners, render_checkerboard
from mcptam_tpu_torch.calib.intrinsic_gpu import refine_lm_gpu
from mcptam_tpu_torch.core.camera import make_camera
from mcptam_tpu_torch.core.se3 import SE3
from mcptam_tpu_torch.ops.fast import topk_corners

PIX_TOL, UV_TOL, RESP_TOL = 1e-3, 1e-3, 1e-5
HOST_RTOL = 1e-9
BLOCK_TOL, STEP_TOL, RESID_TOL = 1e-4, 1e-3, 1e-4
PROJ_TOL, RMS_TOL = 0.75, 1e-3


def p_pose(jpose):
    return SE3(R=t(jpose.R), t=t(jpose.t))


@pytest.fixture(scope="module")
def views():
    """tests/test_calib.py's views: the JAX render and detection, and the
    ground-truth projections."""
    cam = j_make_camera(TRUE_PARAMS, (W, H))
    out = []
    for i in range(6):
        pose = board_pose(i)
        img = np.asarray(j_render(cam, pose, H, W, SQUARES, SQ))
        gt_uv, gt_ok = j_project_corners(cam, pose, SQUARES, SQ)
        grid, _, _ = jcorners.detect_checkerboard(img)
        out.append(dict(img=img, pose=pose, gt_uv=np.asarray(gt_uv),
                        gt_ok=np.asarray(gt_ok), grid=grid))
    return out


@pytest.fixture(scope="module")
def grids(views):
    return _grids_for_calib(views)


@pytest.fixture(scope="module")
def linear_init(grids):
    grids_uv, grids_board = grids
    return jintr.calibrate_linear(grids_uv, grids_board, (W, H))


def test_topk_corners_tie_order():
    """Scores drawn from 6 values, so most of the k = 300 picks tie: the
    stable sort takes tied pixels in raster order, as jax.lax.top_k."""
    rng = np.random.default_rng(0)
    score = rng.integers(0, 6, size=(40, 56)).astype(np.float32)
    score[5, 7] = score[30, 2] = 9.0           # two planted leaders, tied
    jxy, jv, jok = j_topk(jnp.asarray(score), 300, 2.0)
    xy, v, ok = topk_corners(t(score), 300, 2.0)
    np.testing.assert_array_equal(n(xy), np.asarray(jxy))
    np.testing.assert_array_equal(n(v), np.asarray(jv))
    np.testing.assert_array_equal(n(ok), np.asarray(jok))
    assert xy.dtype == torch.int32


@pytest.mark.parametrize("i", [0, 3, 5])
def test_render_and_project_corners(views, i):
    cam = make_camera(TRUE_PARAMS, (W, H), device="cpu")
    img = render_checkerboard(cam, p_pose(views[i]["pose"]), H, W, SQUARES, SQ)
    np.testing.assert_allclose(n(img), views[i]["img"], atol=PIX_TOL, rtol=0)
    uv, ok = project_corners(cam, p_pose(views[i]["pose"]), SQUARES, SQ)
    np.testing.assert_array_equal(n(ok), views[i]["gt_ok"])
    np.testing.assert_allclose(n(uv)[n(ok)], views[i]["gt_uv"][n(ok)], atol=UV_TOL, rtol=0)


def test_xcorner_response(views):
    """On a board view and on noise, whose ring wraps at the border."""
    noise = np.random.default_rng(1).uniform(0, 255, (H, W)).astype(np.float32)
    for img in (views[2]["img"], noise):
        want = np.asarray(jcorners.xcorner_response(jnp.asarray(img)))
        got = n(corners.xcorner_response(t(img)))
        np.testing.assert_allclose(got, want, atol=RESP_TOL * want.max(), rtol=0)


def test_detect_checkerboard_matches_jax(views):
    for v in views:
        grid, xy, good = corners.detect_checkerboard(v["img"], device="cpu")
        _, jxy, jgood = jcorners.detect_checkerboard(v["img"])
        assert good.sum() == jgood.sum()

        def rows(a):
            return a[np.lexsort(a.T[::-1])]

        np.testing.assert_allclose(rows(xy[good]), rows(jxy[jgood]), atol=UV_TOL, rtol=0)
        assert (grid is None) == (v["grid"] is None)
        if grid is not None:
            assert set(grid) == set(v["grid"])
            for k in grid:
                np.testing.assert_allclose(grid[k], v["grid"][k], atol=UV_TOL, rtol=0)


def test_calibrate_linear_matches_jax(grids, linear_init):
    p9, poses = intrinsic.calibrate_linear(*grids, (W, H))
    jp9, jposes = linear_init
    np.testing.assert_allclose(p9, jp9, rtol=HOST_RTOL, atol=0)
    for (R, tt), (jR, jt) in zip(poses, jposes):
        np.testing.assert_allclose(R, jR, rtol=HOST_RTOL, atol=1e-12)
        np.testing.assert_allclose(tt, jt, rtol=HOST_RTOL, atol=1e-12)


def _projection_gap(p_a, p_b):
    """Max distance of the two lenses' projections over the calibrated
    field of view (tests/test_calib.py's comparison)."""
    angles = np.linspace(0.05, 0.75, 30)
    pts = np.stack([np.sin(angles), np.zeros_like(angles), np.cos(angles)], 1) * 2.0
    uv_a, ok_a = jintr.project_calib(p_a, pts, float(np.hypot(W, H)))
    uv_b, ok_b = jintr.project_calib(p_b, pts, float(np.hypot(W, H)))
    both = ok_a & ok_b
    assert both.sum() >= 25
    return np.linalg.norm(uv_a[both] - uv_b[both], axis=1).max()


def _padded(grids, poses):
    """refine_lm's padded (V, K) inputs, as numpy float32."""
    grids_uv, grids_board = grids
    V, K = len(poses), max(len(g) for g in grids_uv)
    board3 = np.zeros((V, K, 3), np.float32)
    uv = np.zeros((V, K, 2), np.float32)
    mask = np.zeros((V, K), bool)
    for i, (g, b) in enumerate(zip(grids_uv, grids_board)):
        board3[i, :len(g), :2] = np.asarray(b)[:, :2]
        uv[i, :len(g)] = g
        mask[i, :len(g)] = True
    R0 = np.stack([p[0] for p in poses]).astype(np.float32)
    t0 = np.stack([p[1] for p in poses]).astype(np.float32)
    return R0, t0, board3, uv, mask


def test_device_lm_step_matches_jax(grids, linear_init):
    """One LM step from the linear init, the poses perturbed: the normal
    equation blocks and the Schur-eliminated step."""
    from mcptam_tpu.calib import intrinsic_tpu as jtpu
    from mcptam_tpu_torch.calib import intrinsic_gpu as pgpu

    p9, poses = linear_init
    rest = _padded(grids, poses)
    eps = (np.random.default_rng(0).normal(size=(len(poses), 6)) * 1e-3).astype(np.float32)
    args = (np.asarray(p9, np.float32), eps) + rest
    want = jax.jit(jtpu._build_normal)(*[jnp.asarray(a) for a in args])
    got = pgpu._build_normal(*[t(a) for a in args])
    np.testing.assert_allclose(n(got[0]), np.asarray(want[0]), atol=RESID_TOL, rtol=0)
    for w_, g_ in zip(want[1:], got[1:]):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(n(g_), w_, atol=BLOCK_TOL * np.abs(w_).max(), rtol=0)
    want = jtpu._lm_step(jnp.asarray(args[0]), jnp.asarray(eps), jnp.float32(1e-3),
                         *[jnp.asarray(a) for a in rest])
    got = pgpu._lm_step(t(args[0]), t(eps), 1e-3, *[t(a) for a in rest])
    for w_, g_ in zip(want, got):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(n(g_), w_, atol=STEP_TOL * np.abs(w_).max(), rtol=0)


def test_device_lm_matches_jax(grids, linear_init):
    """refine_lm_gpu against refine_lm_tpu from the same linear init."""
    p9, poses = linear_init
    jp, _, jrms = refine_lm_tpu(p9, poses, *grids, (W, H))
    pp, _, prms = refine_lm_gpu(p9, poses, *grids, (W, H), device="cpu")
    assert abs(prms - jrms) < RMS_TOL, (prms, jrms)
    assert _projection_gap(pp, jp) < PROJ_TOL


def test_numpy_lm_matches_jax(grids, linear_init):
    """The float64 oracle backend is the same numpy code on both sides."""
    p9, poses = linear_init
    jp, _, jrms = jintr.refine_lm(p9, poses, *grids, (W, H), n_iters=4)
    pp, _, prms = intrinsic.refine_lm(p9, poses, *grids, (W, H), n_iters=4)
    np.testing.assert_allclose(pp, jp, rtol=HOST_RTOL, atol=0)
    assert prms == pytest.approx(jrms, rel=HOST_RTOL)


def test_review_loop_matches_jax(grids):
    """tests/test_calib.py's corrupted view: the port's review loop drops
    the same view as the JAX package's, lands on the same lens and passes
    that test's gates."""
    grids_uv, grids_board = grids
    bad = 1
    rng = np.random.default_rng(5)
    grids_uv = [np.asarray(g, np.float64).copy() for g in grids_uv]
    grids_uv[bad] += rng.normal(size=grids_uv[bad].shape) * 0.8
    jp, jrms, jpv, jkept = jintr.calibrate_camera_reviewed(
        grids_uv, grids_board, (W, H), drop_worst=1)
    p, rms, pv, kept = intrinsic.calibrate_camera_reviewed(
        grids_uv, grids_board, (W, H), drop_worst=1, device="cpu")
    assert kept == jkept and bad not in kept
    assert np.isnan(pv[bad]) and np.isnan(jpv[bad])
    np.testing.assert_allclose(pv[kept], jpv[kept], atol=RMS_TOL)
    assert abs(rms - jrms) < RMS_TOL and rms < 0.5
    assert _projection_gap(p, jp) < PROJ_TOL


def test_camera_calibrator_app_cpu(views, tmp_path, capsys):
    """The app with --device cpu on the six views, held to
    tests/test_apps.py's gates: rc 0, RMS "OK", a0 within 5%, the centre
    within 2 px."""
    from mcptam_tpu_torch.apps.camera_calibrator import main

    imgs = np.stack([v["img"] for v in views]).astype(np.uint8)
    p = str(tmp_path / "views.npy")
    np.save(p, imgs)
    out = str(tmp_path / "camera.json")
    assert main(["--images", p, "--squares", "8x6", "--square-size", "0.04",
                 "--out", out, "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "OK" in text, text
    with open(out) as f:
        got = np.asarray(json.load(f)["cameras"][0]["params"])
    assert abs(got[0] - TRUE_PARAMS[0]) / TRUE_PARAMS[0] < 0.05, got
    assert np.linalg.norm(got[4:6] - TRUE_PARAMS[4:6]) < 2.0, got
