"""Trajectory evaluation: ATE and RPE against ground truth (port of
mcptam_tpu/system/evaluate.py; host numpy).  Poses are base_from_world;
centres are -R^T t."""

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
