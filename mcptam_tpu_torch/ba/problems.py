"""Synthetic bundle problems (port of scripts/bench_ba.py::build): the
entry point of the benchmark's LM stage (bench.py bench_lm).

``build`` draws from numpy's ``default_rng(seed)`` in exactly the order the
JAX script does, so both packages get the same problem from the same seed
(up to float32 rounding of the projected measurements).
"""

from __future__ import annotations

import numpy as np
import torch

from mcptam_tpu_torch.ba.bundle import BundleProblem
from mcptam_tpu_torch.core.camera import project
from mcptam_tpu_torch.core.se3 import SE3
from mcptam_tpu_torch.io.synthetic import make_rig


def build(n_poses, n_points, n_cams, H=480, W=640, seed=0, sparse_k=None,
          noise=0.3, device="cuda"):
    """A random rig bundle: n_poses base poses (the first fixed) around
    points 3-8 m out, perturbed by 0.02 (tangent) and 0.04 m.  sparse_k:
    sample that many random (pose, camera, point) measurements instead of
    the dense product.  noise: measurement noise sigma in pixels.
    Returns (problem, cameras), on ``device``."""
    f32 = torch.float32
    rng = np.random.default_rng(seed)
    cams, cam_from_base = make_rig(n_cams, H, W, spread_deg=25.0, device=device)
    gt = rng.normal(size=(n_poses, 6)) * np.array([0.1] * 3 + [0.03] * 3)
    gt[0] = 0
    pose_a_gt = SE3.exp(torch.as_tensor(gt, dtype=f32, device=device))
    dirs = rng.normal(size=(n_points, 3))
    dirs[:, 2] = np.abs(dirs[:, 2]) + 0.8
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pts = torch.as_tensor(dirs * rng.uniform(3, 8, (n_points, 1)), dtype=f32,
                          device=device)

    mpa, mpb, mpt, mcam, muv, mlvl, mok = [], [], [], [], [], [], []

    def observe(p_ids, c_ids, t_ids, n):
        pi = torch.as_tensor(p_ids, device=device)
        ci = torch.as_tensor(c_ids, device=device)
        pose_m = cam_from_base[ci] @ pose_a_gt[pi]
        uv, ok = project(cams[ci], pose_m.apply(pts[torch.as_tensor(t_ids, device=device)]))
        muv.append(uv.cpu().numpy() + rng.normal(size=(n, 2)) * noise)
        mok.append(ok.cpu().numpy())
        mpa.append(np.asarray(p_ids))
        mpb.append(np.asarray(c_ids))
        mpt.append(np.asarray(t_ids))
        mcam.append(np.asarray(c_ids))
        mlvl.append(np.zeros(n))

    if sparse_k is not None:
        p_ids = rng.integers(0, n_poses, sparse_k)
        c_ids = rng.integers(0, n_cams, sparse_k)
        t_ids = rng.integers(0, n_points, sparse_k)
        observe(p_ids, c_ids, t_ids, sparse_k)
    else:
        for p in range(n_poses):
            for c in range(n_cams):
                observe(np.full(n_points, p), np.full(n_points, c),
                        np.arange(n_points), n_points)
    pert = rng.normal(size=(n_poses, 6)) * 0.02
    pert[0] = 0

    def i32(parts):
        return torch.as_tensor(np.concatenate(parts), dtype=torch.int32, device=device)

    prob = BundleProblem(
        pose_a=SE3.exp(torch.as_tensor(pert, dtype=f32, device=device)) @ pose_a_gt,
        pose_b=cam_from_base,
        movable_a=torch.as_tensor([False] + [True] * (n_poses - 1), device=device),
        movable_b=torch.zeros(n_cams, dtype=torch.bool, device=device),
        points=pts + torch.as_tensor(rng.normal(size=(n_points, 3)) * 0.04,
                                     dtype=f32, device=device),
        movable_pt=torch.ones(n_points, dtype=torch.bool, device=device),
        m_pose_a=i32(mpa), m_pose_b=i32(mpb), m_point=i32(mpt), m_cam=i32(mcam),
        m_uv=torch.as_tensor(np.concatenate(muv), dtype=f32, device=device),
        m_level=i32(mlvl),
        m_valid=torch.as_tensor(np.concatenate(mok), device=device),
    )
    return prob, cams
