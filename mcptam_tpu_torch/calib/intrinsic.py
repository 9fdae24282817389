"""Intrinsic (Taylor model) camera calibration from checkerboard views
(port of mcptam_tpu/calib/intrinsic.py).

Re-implements the reference CameraCalibrator (src/CameraCalibrator.cc):

  * per-view linear extrinsics (Scaramuzza sec 3.2.1 — the reference's
    CalibImageTaylor::GuessInitialPose);
  * global linear solve for [a0,a2,a3,a4] + per-view t_z stacked over all
    views (sec 3.2.2 — ComputeParamsUpdatePoses,
    src/CameraCalibrator.cc:620-666);
  * projection-center search: shrinking 5x5 grid evaluated by the linear
    system residual (FindBestCenter, src/CameraCalibrator.cc:557-616);
  * full nonlinear refinement over 9 camera params + 6-DOF per view
    poses, minimizing reprojection error with the calibration-mode
    (root-solving) projection (OptimizeOneStepLM,
    src/CameraCalibrator.cc:439-555).

All host-side numpy float64 (calibration is offline) but the nonlinear
refinement's default backend, the Schur-eliminated LM on the device
(calib/intrinsic_gpu.py); the tracker consumes the resulting parameters
through core.camera.make_camera."""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Calibration-mode projection (double precision, exact root solving)
# ---------------------------------------------------------------------------

def project_calib(params9, pts_cam, max_rho):
    """Project cam-frame points with exact quartic root solving (the
    reference's calibration-mode Project, src/TaylorCamera.cc:235-258).
    Returns (uv (N,2), valid (N,))."""
    a0, a2, a3, a4, xc, yc, c, d, e = params9
    A = np.array([[c, d], [e, 1.0]])
    uv = np.zeros((len(pts_cam), 2))
    ok = np.zeros(len(pts_cam), bool)
    for i, p in enumerate(pts_cam):
        x, y, z = p
        norm = np.hypot(x, y)
        if norm < 1e-12:
            uv[i] = (xc, yc)
            ok[i] = True
            continue
        tan_t = z / norm
        roots = np.roots([a4, a3, a2, -tan_t, a0])
        real = roots[np.abs(roots.imag) < 1e-9].real
        real = real[(real > 0) & (real < max_rho)]
        if len(real) != 1:
            ok[i] = False
            continue
        rho = real[0]
        m = np.array([x / norm * rho, y / norm * rho])
        uv[i] = A @ m + np.array([xc, yc])
        ok[i] = True
    return uv, ok


# ---------------------------------------------------------------------------
# Linear initialization
# ---------------------------------------------------------------------------

def _linear_extrinsics(board_pts, sensor_uv):
    """Scaramuzza 3.2.1: partial extrinsics [r11 r12 r21 r22 t1 t2] (up to
    scale) from planar points.  Returns the two R/t candidates (r3 sign)."""
    X, Y = board_pts[:, 0], board_pts[:, 1]
    u, v = sensor_uv[:, 0], sensor_uv[:, 1]
    M = np.stack([-v * X, -v * Y, u * X, u * Y, -v, u], axis=1)
    _, _, Vt = np.linalg.svd(M, full_matrices=False)
    h = Vt[-1]
    a, b, cc, dd, t1, t2 = h
    # sign: cam-frame x should correlate with sensor u
    corr = np.sum((a * X + b * Y + t1) * u)
    if corr < 0:
        h = -h
        a, b, cc, dd, t1, t2 = h
    # recover r31, r32 from orthonormality
    K1 = (b * b + dd * dd) - (a * a + cc * cc)   # r31^2 - r32^2
    K2 = -(a * b + cc * dd)                      # r31*r32
    r31_sq = (K1 + np.sqrt(K1 * K1 + 4 * K2 * K2)) / 2.0
    r31 = np.sqrt(max(r31_sq, 0.0))
    candidates = []
    for s in (1.0, -1.0):
        r31_c = s * r31
        r32_c = K2 / r31_c if abs(r31_c) > 1e-12 else np.sqrt(max(-K1, 0.0))
        R1 = np.array([a, cc, r31_c])
        R2 = np.array([b, dd, r32_c])
        lam = 1.0 / max(np.linalg.norm(R1), 1e-12)
        R1n, R2n = R1 * lam, R2 * lam
        # Gram-Schmidt to clean R2
        R2n = R2n - R1n * (R1n @ R2n)
        n2 = np.linalg.norm(R2n)
        if n2 < 1e-9:
            continue
        R2n /= n2
        R3 = np.cross(R1n, R2n)
        R = np.stack([R1n, R2n, R3], axis=1)  # columns
        t12 = np.array([t1, t2]) * lam
        candidates.append((R, t12))
    return candidates


def _intrinsic_system(views, centers_uv, rho):
    """Build the stacked linear system for [a0,a2,a3,a4, t3_i...].

    views: list of dicts with R, t12, board_pts, sensor_uv (centered).
    Returns (A, b) with two rows per point (sec 3.2.2)."""
    n_views = len(views)
    rows_A, rows_b = [], []
    for i, vw in enumerate(views):
        R, t12 = vw["R"], vw["t12"]
        P = vw["board_pts"]
        uv = vw["sensor_uv"]
        rho_i = vw["rho"]
        X, Y = P[:, 0], P[:, 1]
        u, vv = uv[:, 0], uv[:, 1]
        A_ = R[0, 0] * X + R[0, 1] * Y + t12[0]   # cam x (no t3)
        B_ = R[1, 0] * X + R[1, 1] * Y + t12[1]   # cam y
        C_ = R[2, 0] * X + R[2, 1] * Y             # cam z w/o t3
        poly_basis = np.stack(
            [np.ones_like(rho_i), rho_i**2, rho_i**3, rho_i**4], axis=1
        )
        for lhs, img_coord in ((B_, vv), (A_, u)):
            # img * (C + t3) = f(rho) * lhs   ->
            # lhs*poly_basis @ a - img*t3 = img * C
            Arow = np.zeros((len(X), 4 + n_views))
            Arow[:, :4] = lhs[:, None] * poly_basis
            Arow[:, 4 + i] = -img_coord
            rows_A.append(Arow)
            rows_b.append(img_coord * C_)
    return np.concatenate(rows_A), np.concatenate(rows_b)


def _solve_linear(grids_uv, grids_board, center):
    """Linear init at a given projection center.  Returns (params, poses,
    residual) — params = [a0,a2,a3,a4], poses = list of (R, t (3,));
    residual = normalized lstsq residual (the center-search score)."""
    views = []
    for uv_img, P in zip(grids_uv, grids_board):
        s_uv = uv_img - center
        rho = np.linalg.norm(s_uv, axis=1)
        cands = _linear_extrinsics(P, s_uv)
        if not cands:
            return None
        views.append(
            [dict(R=R, t12=t12, board_pts=P, sensor_uv=s_uv, rho=rho)
             for R, t12 in cands]
        )

    # candidate selection: each view has two R/t candidates (the r31 sign
    # ambiguity).  Seed with the physically plausible one — a visible board
    # faces the camera, so its +z normal maps near (0,0,-1) in cam frame,
    # i.e. R[2,2] < 0 — then greedy coordinate-descent sweeps on the joint
    # residual until stable (the one-pass greedy was order-dependent and
    # could lock in a bad combination).
    for v in views:
        v.sort(key=lambda d: d["R"][2, 2])
    chosen = [v[0] for v in views]
    for _ in range(4):
        changed = False
        for i, opts in enumerate(views):
            best = None
            for opt in opts:
                trial = list(chosen)
                trial[i] = opt
                A, b = _intrinsic_system(trial, None, None)
                x, res, *_ = np.linalg.lstsq(A, b, rcond=None)
                t3 = x[4 + i]
                r = np.linalg.norm(A @ x - b)
                score = r + (1e6 if t3 <= 0 else 0.0)
                if best is None or score < best[0]:
                    best = (score, opt)
            if best[1] is not chosen[i]:
                chosen[i] = best[1]
                changed = True
        if not changed:
            break

    A, b = _intrinsic_system(chosen, None, None)
    x, *_ = np.linalg.lstsq(A, b, rcond=None)
    resid = np.linalg.norm(A @ x - b) / np.sqrt(len(b))
    a = x[:4]
    poses = []
    bad = False
    for i, vw in enumerate(chosen):
        t3 = x[4 + i]
        if t3 <= 0:
            bad = True
        t = np.array([vw["t12"][0], vw["t12"][1], t3])
        poses.append((vw["R"], t))
    if bad:
        resid += 1e6
    return a, poses, resid


def calibrate_linear(grids_uv, grids_board, image_size, n_center_iters=20):
    """Center grid search + linear solve (InitOptimization analogue).

    grids_uv: list per view of (N,2) detected corner pixels;
    grids_board: matching (N,2or3) board-frame coords.
    Returns (params9, poses)."""
    grids_board = [np.asarray(P)[:, :2] for P in grids_board]
    grids_uv = [np.asarray(g, np.float64) for g in grids_uv]
    center = np.asarray(image_size, np.float64) / 2.0
    spread = np.asarray(image_size, np.float64) / 4.0
    best = None
    for _ in range(n_center_iters):
        for dy in (-1, -0.5, 0, 0.5, 1):
            for dx in (-1, -0.5, 0, 0.5, 1):
                c = center + spread * np.array([dx, dy])
                out = _solve_linear(grids_uv, grids_board, c)
                if out is None:
                    continue
                a, poses, resid = out
                if best is None or resid < best[0]:
                    best = (resid, c, a, poses)
        center = best[1]
        spread *= 0.5
    resid, c, a, poses = best
    params9 = np.array([a[0], a[1], a[2], a[3], c[0], c[1], 1.0, 0.0, 0.0])
    return params9, poses


# ---------------------------------------------------------------------------
# Nonlinear refinement
# ---------------------------------------------------------------------------

def _se3_apply(Rt, pts):
    R, t = Rt
    return pts @ R.T + t


def _rodrigues(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _residuals(params9, poses, grids_uv, grids_board, max_rho):
    res = []
    for (R, t), uv_img, P2 in zip(poses, grids_uv, grids_board):
        P = np.concatenate([P2, np.zeros((len(P2), 1))], axis=1)
        pc = _se3_apply((R, t), P)
        uv, ok = project_calib(params9, pc, max_rho)
        r = (uv - uv_img)
        r[~ok] = 25.0  # penalty for invalid projections
        res.append(r.reshape(-1))
    return np.concatenate(res)


def refine_lm(params9, poses, grids_uv, grids_board, image_size,
              n_iters=15, verbose=False):
    """Full LM over camera params + per-view poses with numeric Jacobians
    (offline; the reference does analytic pose + numeric camera)."""
    grids_board = [np.asarray(P)[:, :2] for P in grids_board]
    grids_uv = [np.asarray(g, np.float64) for g in grids_uv]
    W, H = image_size
    max_rho = float(np.hypot(W, H))  # generous
    n_views = len(poses)

    def unpack(x):
        p9 = x[:9]
        ps = []
        for i in range(n_views):
            w = x[9 + 6 * i : 12 + 6 * i]
            t = x[12 + 6 * i : 15 + 6 * i]
            ps.append((_rodrigues(w) @ poses[i][0], poses[i][1] + t))
        return p9, ps

    x = np.concatenate([np.asarray(params9, np.float64), np.zeros(6 * n_views)])
    lam = 1e-3
    r = _residuals(*unpack(x), grids_uv, grids_board, max_rho)
    cost = r @ r
    # parameter scaling for FD steps
    steps = np.concatenate([
        np.maximum(np.abs(x[:9]) * 1e-4, 1e-7), np.full(6 * n_views, 1e-6)
    ])
    for it in range(n_iters):
        J = np.zeros((len(r), len(x)))
        for j in range(len(x)):
            xp = x.copy()
            xp[j] += steps[j]
            rp = _residuals(*unpack(xp), grids_uv, grids_board, max_rho)
            J[:, j] = (rp - r) / steps[j]
        JtJ = J.T @ J
        g = J.T @ r
        for _ in range(6):
            try:
                dx = np.linalg.solve(JtJ + lam * np.diag(np.diag(JtJ)) + 1e-12 * np.eye(len(x)), -g)
            except np.linalg.LinAlgError:
                lam *= 10
                continue
            r_new = _residuals(*unpack(x + dx), grids_uv, grids_board, max_rho)
            if r_new @ r_new < cost:
                x = x + dx
                r = r_new
                cost = r_new @ r_new
                lam = max(lam * 0.3, 1e-9)
                break
            lam *= 10
        if verbose:
            print(f"LM iter {it}: rms {np.sqrt(cost/len(r)):.4f} px lam {lam:.1e}")
    p9, ps = unpack(x)
    rms = np.sqrt(cost / len(r))
    return p9, ps, rms


def calibrate_camera(grids_uv, grids_board, image_size, verbose=False,
                     backend: str = "device", full_output: bool = False,
                     device="cuda"):
    """End-to-end intrinsic calibration.  Returns (params9, rms_px), or
    (params9, rms_px, poses) with full_output=True.

    backend="device" (default) runs the batched Schur-eliminated LM on
    ``device`` (calib.intrinsic_gpu; the reference's OptimizeOneStepLM
    elimination order, src/CameraCalibrator.cc:439-555); backend="numpy"
    keeps the host float64 full-Jacobian LM as a cross-check oracle."""
    params9, poses = calibrate_linear(grids_uv, grids_board, image_size)
    if backend == "device":
        from mcptam_tpu_torch.calib.intrinsic_gpu import refine_lm_gpu
        params9, poses, rms = refine_lm_gpu(
            params9, poses, grids_uv, grids_board, image_size,
            verbose=verbose, device=device,
        )
    elif backend == "numpy":
        params9, poses, rms = refine_lm(
            params9, poses, grids_uv, grids_board, image_size,
            verbose=verbose,
        )
    else:
        raise ValueError(f"calibrate_camera: unknown backend {backend!r}")
    if full_output:
        return params9, rms, poses
    return params9, rms


def per_view_rms(params9, poses, grids_uv, grids_board, image_size):
    """Per-view reprojection RMS in px at the given solution — the review
    metric behind the reference calibrator's grabbed-frame review loop
    (the operator watches each grab's residuals and discards bad boards
    before optimizing, CameraCalibrator::Run,
    src/CameraCalibrator.cc:128-244)."""
    W, H = image_size
    max_rho = float(np.hypot(W, H))
    out = []
    for (R, t), uv_img, P2 in zip(poses, grids_uv, grids_board):
        P2 = np.asarray(P2)[:, :2]
        P = np.concatenate([P2, np.zeros((len(P2), 1))], axis=1)
        pc = _se3_apply((np.asarray(R), np.asarray(t)), P)
        uv, ok = project_calib(params9, pc, max_rho)
        r = uv - np.asarray(uv_img, np.float64)
        r[~ok] = 25.0
        out.append(float(np.sqrt(np.mean(np.sum(r * r, axis=1)))))
    return np.asarray(out)


def calibrate_camera_reviewed(grids_uv, grids_board, image_size,
                              drop_worst: int = 0, verbose=False,
                              backend: str = "device", device="cuda"):
    """Calibrate, review per-view residuals, optionally discard the worst
    views and re-optimize — the headless analogue of the reference
    calibrator's grab/review/discard loop.  Returns
    (params9, rms, per_view, kept_indices)."""
    params9, rms, poses = calibrate_camera(
        grids_uv, grids_board, image_size, verbose=verbose,
        backend=backend, full_output=True, device=device,
    )
    pv = per_view_rms(params9, poses, grids_uv, grids_board, image_size)
    kept = list(range(len(grids_uv)))
    n_drop = min(int(drop_worst), max(len(grids_uv) - 3, 0))
    if n_drop > 0:
        order = np.argsort(pv)[::-1]
        dropped = set(int(i) for i in order[:n_drop])
        kept = [i for i in kept if i not in dropped]
        params9, rms, poses = calibrate_camera(
            [grids_uv[i] for i in kept], [grids_board[i] for i in kept],
            image_size, verbose=verbose, backend=backend, full_output=True,
            device=device,
        )
        pv_kept = per_view_rms(
            params9, poses, [grids_uv[i] for i in kept],
            [grids_board[i] for i in kept], image_size,
        )
        pv = np.full(len(grids_uv), np.nan)
        for k, i in enumerate(kept):
            pv[i] = pv_kept[k]
    return params9, rms, pv, kept
