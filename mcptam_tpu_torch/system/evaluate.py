"""Trajectory evaluation: ATE and RPE against ground truth, and the score
of a tracked run (port of mcptam_tpu/system/evaluate.py; host numpy,
float64).  Poses are base_from_world; centres are -R^T t."""

from __future__ import annotations

import numpy as np


def _as_Rt(poses) -> tuple:
    arr = np.asarray(poses, np.float64)
    assert arr.ndim == 3 and arr.shape[1:] == (3, 4), arr.shape
    return arr[:, :, :3], arr[:, :, 3]


def centers(poses) -> np.ndarray:
    """(T,3,4) poses -> (T,3) world-frame centres."""
    R, t = _as_Rt(poses)
    return -np.einsum("tij,ti->tj", R, t)


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = True):
    """Least-squares similarity y ~ s R x + t (Umeyama 1991) -> (s, R, t)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    mx, my = x.mean(0), y.mean(0)
    xc, yc = x - mx, y - my
    U, D, Vt = np.linalg.svd(yc.T @ xc / len(x))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    s = (float(np.trace(np.diag(D) @ S) / max((xc ** 2).sum() / len(x), 1e-18))
         if with_scale else 1.0)
    return s, R, my - s * R @ mx


def ate_rmse(est_poses, gt_poses, align: bool = True,
             with_scale: bool = True) -> dict:
    """Absolute trajectory error of two (T,3,4) pose arrays after an
    optional similarity alignment: {"rmse", "mean", "median", "max", "scale"}."""
    pe, pg = centers(est_poses), centers(gt_poses)
    assert pe.shape == pg.shape, (pe.shape, pg.shape)
    s = 1.0
    if align and len(pe) >= 3:
        s, R, t = umeyama_alignment(pe, pg, with_scale)
        pe = (s * (R @ pe.T)).T + t
    err = np.linalg.norm(pe - pg, axis=-1)
    return {"rmse": float(np.sqrt(np.mean(err ** 2))), "mean": float(err.mean()),
            "median": float(np.median(err)), "max": float(err.max()),
            "scale": float(s)}


def rpe(est_poses, gt_poses, delta: int = 1) -> dict:
    """Relative pose error at step ``delta``: translation RMSE (world units)
    and rotation RMSE (degrees) of the motions P_j P_i^-1, j = i + delta."""
    Re, te = _as_Rt(est_poses)
    Rg, tg = _as_Rt(gt_poses)
    T = len(Re)
    if T <= delta:
        raise ValueError(f"{T} poses are too few for a step of {delta}")
    dts, drs = [], []
    for i in range(T - delta):
        j = i + delta
        dRe = Re[j] @ Re[i].T
        dte = te[j] - dRe @ te[i]
        dRg = Rg[j] @ Rg[i].T
        dtg = tg[j] - dRg @ tg[i]
        cos = np.clip((np.trace(dRe.T @ dRg) - 1.0) / 2.0, -1.0, 1.0)
        drs.append(np.degrees(np.arccos(cos)))
        dts.append(np.linalg.norm(dte - dtg))
    dts, drs = np.asarray(dts), np.asarray(drs)
    return {"trans_rmse": float(np.sqrt(np.mean(dts ** 2))),
            "rot_rmse_deg": float(np.sqrt(np.mean(drs ** 2)))}


def evaluate_run(infos, gt_poses, delta: int = 1) -> dict:
    """Score a tracked run: ``infos`` are FrameInfos (``.pose`` (3,4),
    ``.lost``), ``gt_poses`` the (T,3,4) ground-truth base_from_world ->
    {"ate", "rpe", "lost_frames"}."""
    est = np.stack([i.pose for i in infos])
    gt = np.asarray(gt_poses, np.float64)
    if len(est) != len(gt):
        raise ValueError(f"{len(est)} tracked frames against {len(gt)} ground-truth poses")
    return {"ate": ate_rmse(est, gt), "rpe": rpe(est, gt, delta),
            "lost_frames": int(sum(bool(i.lost) for i in infos))}
