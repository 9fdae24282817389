"""Extrinsic (rig) calibration: camera-from-base poses from shared
checkerboard observations (port of mcptam_tpu/calib/extrinsic.py).

Re-implements the PoseCalibrator pipeline (src/PoseCalibrator.cc,
src/MapMakerCalib.cc, src/TrackerCalib.cc) without the GUI/ROS shell:

  1. per (frame, camera) board detection -> single-camera pose
     (linear Scaramuzza extrinsics + LM, as TrackerCalib's checkerboard
     bootstrap);
  2. relative-pose averaging: for every frame where camera 0 and camera c
     both see the board, accumulate T_c0 = pose_c @ pose_0^-1; geodesic-L2
     rotation averaging + translation mean initializes cam_from_base
     (FindAverageRelativePoses, src/MapMakerCalib.cc:248-345, after
     Dai et al.);
  3. joint refinement with the Calib bundle variant: fixed board corner
     points, movable per-frame base poses + shared movable extrinsics
     (BundleAdjusterCalib, src/BundleAdjusterCalib.cc): a bundle problem
     without an observation table, on the LM's scatter path.
"""

from __future__ import annotations

import numpy as np
import torch

from mcptam_tpu_torch.ba.bundle import BundleProblem, create_lm_state, lm_run
from mcptam_tpu_torch.calib.intrinsic import (
    _linear_extrinsics, _rodrigues, project_calib,
)
from mcptam_tpu_torch.core.camera import CameraModel
from mcptam_tpu_torch.core.se3 import SE3, geodesic_rotation_mean


def board_pose_pnp(params9, board_pts2, uv_img, image_size, n_iters=12):
    """Single-view board pose (cam_from_board) from detected corners:
    linear init + LM, host numpy f64 (the reference seeds with the linear
    solve then refines via ChainBundle, src/TrackerCalib.cc:163-243).

    Returns (R, t) with p_cam = R @ p_board + t, or None."""
    center = np.asarray(params9[4:6], np.float64)
    s_uv = np.asarray(uv_img, np.float64) - center
    cands = _linear_extrinsics(np.asarray(board_pts2, np.float64), s_uv)
    if not cands:
        return None
    W, H = image_size
    max_rho = float(np.hypot(W, H))
    P3 = np.concatenate(
        [board_pts2, np.zeros((len(board_pts2), 1))], axis=1
    )

    def resid(R, t):
        pc = P3 @ R.T + t
        uv, ok = project_calib(params9, pc, max_rho)
        r = uv - uv_img
        r[~ok] = 50.0
        return r.reshape(-1)

    best = None
    for R, t12 in cands:
        # t3 init: scale from mean corner spread (rough); LM corrects it
        for t3 in (0.2, 0.4, 0.8):
            t = np.array([t12[0], t12[1], t3])
            r = resid(R, t)
            c = r @ r
            if best is None or c < best[0]:
                best = (c, R, t)
    _, R, t = best

    x = np.zeros(6)
    lam = 1e-3
    r = resid(R, t)
    cost = r @ r
    for _ in range(n_iters):
        J = np.zeros((len(r), 6))
        for j in range(6):
            xp = np.zeros(6)
            xp[j] = 1e-6
            Rp = _rodrigues(xp[:3]) @ R
            tp = t + xp[3:]
            J[:, j] = (resid(Rp, tp) - r) / 1e-6
        g = J.T @ r
        JtJ = J.T @ J
        for _ in range(5):
            try:
                dx = np.linalg.solve(JtJ + lam * np.diag(np.diag(JtJ)) + 1e-12 * np.eye(6), -g)
            except np.linalg.LinAlgError:
                lam *= 10
                continue
            Rn = _rodrigues(dx[:3]) @ R
            tn = t + dx[3:]
            rn = resid(Rn, tn)
            if rn @ rn < cost:
                R, t, r, cost = Rn, tn, rn, rn @ rn
                lam = max(lam * 0.3, 1e-9)
                break
            lam *= 10
    rms = np.sqrt(cost / len(r))
    if rms > 3.0:
        return None
    return R, t


def average_relative_poses(rel_poses, device="cuda"):
    """Geodesic-L2 mean of a list of (R, t) relative poses
    (FindAverageRelativePoses, src/MapMakerCalib.cc:248-345), in float32
    on ``device``.  Returns numpy (R, t)."""
    Rs = torch.as_tensor(np.stack([R for R, _ in rel_poses]), dtype=torch.float32,
                         device=device)
    mask = torch.ones(len(rel_poses), device=device)
    R_mean = geodesic_rotation_mean(Rs, mask, iters=20)
    t_mean = np.mean([t for _, t in rel_poses], axis=0).astype(np.float32)
    return R_mean.cpu().numpy(), t_mean


def calibrate_rig(params9_per_cam, observations, board_pts2, image_size,
                  cams: CameraModel, n_lm_steps: int = 80):
    """Full extrinsic calibration.

    observations: dict[(frame, cam)] -> dict(uv (N,2), board_idx (N,))
      — detected corners per frame per camera, with indices into
      board_pts2 (K,2) shared board-corner table.  The bundle runs on the
    cameras' device.
    Returns (cam_from_base: SE3 (C,), per-frame base poses, final LM state).
    """
    dev = cams.center.device
    C = len(params9_per_cam)
    frames = sorted({f for (f, c) in observations})
    F = len(frames)

    # --- step 1: per-(frame,cam) PnP
    pnp = {}
    for (f, c), obs in observations.items():
        bp = board_pts2[obs["board_idx"]]
        out = board_pose_pnp(params9_per_cam[c], bp, obs["uv"], image_size)
        if out is not None:
            pnp[(f, c)] = out  # cam_from_board

    # --- step 2: relative-pose averaging vs camera 0
    cam_from_base_np = [(np.eye(3), np.zeros(3))]
    for c in range(1, C):
        rels = []
        for f in frames:
            if (f, 0) in pnp and (f, c) in pnp:
                R0, t0 = pnp[(f, 0)]
                Rc, tc = pnp[(f, c)]
                # T_c_from_0 = T_c_from_board @ T_board_from_0
                R_rel = Rc @ R0.T
                t_rel = tc - R_rel @ t0
                rels.append((R_rel, t_rel))
        if not rels:
            raise ValueError(f"no shared board views between cam 0 and cam {c}")
        cam_from_base_np.append(average_relative_poses(rels, device=dev))

    # --- step 3: joint BA (Calib chain layout) over fixed board points
    # pose_a[f] = base(=cam0)_from_world with world == board frame;
    # pose_b[c] = cam_from_base shared extrinsics (cam0 fixed = identity)
    K = board_pts2.shape[0]

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

    def i32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int32, device=dev)

    def flag(a):
        return torch.as_tensor(np.asarray(a, bool), device=dev)

    pose_a = SE3(
        R=f32(np.stack([pnp[(f, 0)][0] if (f, 0) in pnp else np.eye(3)
                        for f in frames])),
        t=f32(np.stack([pnp[(f, 0)][1] if (f, 0) in pnp else np.zeros(3)
                        for f in frames])),
    )
    pose_b = SE3(R=f32(np.stack([R for R, _ in cam_from_base_np])),
                 t=f32(np.stack([t for _, t in cam_from_base_np])))
    points = f32(np.concatenate([board_pts2, np.zeros((K, 1))], axis=1))

    m_pose_a, m_pose_b, m_point, m_cam, m_uv = [], [], [], [], []
    for fi, f in enumerate(frames):
        for c in range(C):
            if (f, c) not in observations:
                continue
            obs = observations[(f, c)]
            n = len(obs["uv"])
            m_pose_a.append(np.full(n, fi))
            m_pose_b.append(np.full(n, c))
            m_point.append(obs["board_idx"])
            m_cam.append(np.full(n, c))
            m_uv.append(obs["uv"])
    m_pose_a = np.concatenate(m_pose_a)
    Km = len(m_pose_a)
    prob = BundleProblem(
        pose_a=pose_a,
        pose_b=pose_b,
        movable_a=flag([(f, 0) in pnp for f in frames]),
        movable_b=flag([False] + [True] * (C - 1)),
        points=points,
        movable_pt=flag(np.zeros(K, bool)),  # board geometry is known and fixed
        m_pose_a=i32(m_pose_a),
        m_pose_b=i32(np.concatenate(m_pose_b)),
        m_point=i32(np.concatenate(m_point)),
        m_cam=i32(np.concatenate(m_cam)),
        m_uv=f32(np.concatenate(m_uv)),
        m_level=i32(np.zeros(Km)),
        m_valid=flag(np.ones(Km, bool)),
    )
    st = lm_run(prob, create_lm_state(prob), cams, n_lm_steps)
    return SE3(R=st.pose_b.R, t=st.pose_b.t), st.pose_a, st
