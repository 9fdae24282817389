"""Nonlinear intrinsic refinement on the device: a batched LM with the
per-view pose blocks Schur-eliminated (port of
mcptam_tpu/calib/intrinsic_tpu.py, whose ``refine_lm_tpu`` this module's
``refine_lm_gpu`` is).

The reference's CameraCalibrator::OptimizeOneStepLM
(src/CameraCalibrator.cc:439-555) eliminates the pose blocks from the
normal equations and solves a small camera-parameter system.  Here:

  * all views padded to one (V, K) measurement tensor;
  * the calibration-mode projection solves ``poly(rho) = rho tan(theta)``
    by 10 Newton steps seeded from the MEASURED sensor radius (the
    measurement-consistent root), in place of the reference's
    companion-matrix root enumeration (src/TaylorCamera.cc:235-258);
  * Jacobians by forward-mode differentiation through that loop
    (``torch.func.jacfwd``, vmapped over views), so the pose blocks come
    out block-diagonal; the Newton seed is held constant, as the JAX
    module's ``stop_gradient`` holds it;
  * Schur: S = U - sum_i W_i V_i^-1 W_i^T over the 9 camera parameters,
    then back-substitution for the 6-DOF pose updates.  S is 9x9 and the
    JAX module solves it with ``jnp.linalg.solve``; so does this one, with
    ``torch.linalg.solve``.

Everything is float32 on the device.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd, vmap


def _rodrigues_j(w: torch.Tensor) -> torch.Tensor:
    """exp(skew(w)) with series forms at w = 0: the LM starts at eps = 0
    exactly, where the derivative must not see a w/|w| singularity."""
    th2 = torch.sum(w * w)
    small = th2 < 1e-8
    safe = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(safe)
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    B = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / safe)
    z = torch.zeros_like(w[0])
    K = torch.stack([
        torch.stack([z, -w[2], w[1]]),
        torch.stack([w[2], z, -w[0]]),
        torch.stack([-w[1], w[0], z]),
    ])
    return torch.eye(3, dtype=w.dtype, device=w.device) + A * K + B * (K @ K)


def _project_calib_newton(p9, pc, rho_init, n_newton: int = 10):
    """Calibration-mode projection of camera-frame points pc (...,3): solve
    a4 r^4 + a3 r^3 + a2 r^2 + a0 = r tan(theta) by Newton from rho_init
    (the measured sensor radius).  Returns (uv (...,2), ok)."""
    a0, a2, a3, a4, xc, yc, c, d, e = [p9[i] for i in range(9)]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    norm = torch.sqrt(x * x + y * y + 1e-24)
    tan_t = z / norm
    rho = torch.clamp(rho_init, min=1e-3)
    for _ in range(n_newton):
        g = a0 + rho * rho * (a2 + rho * (a3 + rho * a4)) - rho * tan_t
        gp = rho * (2.0 * a2 + rho * (3.0 * a3 + rho * 4.0 * a4)) - tan_t
        rho = rho - g / torch.where(torch.abs(gp) < 1e-9, torch.full_like(gp, 1e-9), gp)
    g = a0 + rho * rho * (a2 + rho * (a3 + rho * a4)) - rho * tan_t
    ok = (torch.abs(g) < 1e-3 * torch.abs(a0)) & (rho > 0.0)
    mx = x / norm * rho
    my = y / norm * rho
    return torch.stack([c * mx + d * my + xc, e * mx + my + yc], -1), ok


def _seed_radius(p9, uv_meas):
    """The measured sensor radius under the current affine and centre: the
    Newton seed, which tracks the parameters being optimised but is not
    differentiated."""
    xc, yc, c, d, e = p9[4], p9[5], p9[6], p9[7], p9[8]
    du = uv_meas[..., 0] - xc
    dv = uv_meas[..., 1] - yc
    det = c - d * e
    mx = (du - d * dv) / det
    my = (c * dv - e * du) / det
    return torch.sqrt(mx * mx + my * my + 1e-12)


def _residual_view(p9, eps, R0, t0, board3, uv_meas, mask, rho0):
    """Masked residuals (2K,) and weights (K,) of one view under the pose
    tangent eps = [w, dt]."""
    R = _rodrigues_j(eps[:3]) @ R0
    pc = board3 @ R.T + (t0 + eps[3:])
    uv, ok = _project_calib_newton(p9, pc, rho0)
    w = (mask & ok).to(uv.dtype)
    return ((uv - uv_meas) * w[..., None]).reshape(-1), w


_VIEWS = (None, 0, 0, 0, 0, 0, 0, 0)     # p9 shared, the rest per view


def _build_normal(p9, eps, R0, t0, board3, uv, mask):
    """Residuals, cost and the normal-equation blocks: U (9,9), V (V,6,6),
    W (V,9,6), g_c (9,), g_p (V,6)."""
    rho0 = _seed_radius(p9, uv)
    r, _ = vmap(_residual_view, in_dims=_VIEWS)(p9, eps, R0, t0, board3, uv, mask, rho0)
    (Jc, Jp), _ = vmap(jacfwd(_residual_view, argnums=(0, 1), has_aux=True), in_dims=_VIEWS)(
        p9, eps, R0, t0, board3, uv, mask, rho0)          # (V,2K,9), (V,2K,6)
    U = torch.einsum("vki,vkj->ij", Jc, Jc)
    Vb = torch.einsum("vki,vkj->vij", Jp, Jp)
    Wb = torch.einsum("vki,vkj->vij", Jc, Jp)
    gc = torch.einsum("vki,vk->i", Jc, r)
    gp = torch.einsum("vki,vk->vi", Jp, r)
    return r, torch.sum(r * r), U, Vb, Wb, gc, gp


def _lm_step(p9, eps, lam, R0, t0, board3, uv, mask):
    """One Schur-eliminated LM solve: (delta_c (9,), delta_p (V,6), cost)."""
    _, cost, U, Vb, Wb, gc, gp = _build_normal(p9, eps, R0, t0, board3, uv, mask)
    eye6 = torch.eye(6, dtype=U.dtype, device=U.device)
    eye9 = torch.eye(9, dtype=U.dtype, device=U.device)
    Ud = U + lam * torch.diag(torch.diagonal(U)) + 1e-6 * eye9
    Vd = Vb + lam * (Vb * eye6) + 1e-6 * eye6
    Vinv = torch.linalg.inv(Vd)                                  # (V,6,6)
    WVinv = torch.einsum("vij,vjk->vik", Wb, Vinv)               # (V,9,6)
    S = Ud - torch.einsum("vik,vjk->ij", WVinv, Wb)
    rhs = -(gc - torch.einsum("vik,vk->i", WVinv, gp))
    dc = torch.linalg.solve(S, rhs)
    dp = -torch.einsum("vij,vj->vi", Vinv, gp + torch.einsum("vji,j->vi", Wb, dc))
    return dc, dp, cost


def _cost_at(p9, eps, R0, t0, board3, uv, mask):
    """(cost, active measurement count) at the given parameters.  The count
    guards the accept test: a trial must not "improve" the cost by making
    the projection's Newton solve fail on measurements (w -> 0 removes
    their residuals), so steps that shrink the active set are rejected."""
    rho0 = _seed_radius(p9, uv)
    r, w = vmap(_residual_view, in_dims=_VIEWS)(p9, eps, R0, t0, board3, uv, mask, rho0)
    return torch.sum(r * r), torch.sum(w)


def refine_lm_gpu(params9, poses, grids_uv, grids_board, image_size,
                  n_iters: int = 15, verbose: bool = False, device="cuda"):
    """calib.intrinsic.refine_lm's interface, on ``device``.  Returns
    (params9, poses, rms_px)."""
    V = len(poses)
    K = max(len(g) for g in grids_uv)
    board3 = np.zeros((V, K, 3), np.float32)
    uv = np.zeros((V, K, 2), np.float32)
    mask = np.zeros((V, K), bool)
    for i, (g, b) in enumerate(zip(grids_uv, grids_board)):
        n = len(g)
        board3[i, :n, :2] = np.asarray(b)[:, :2]
        uv[i, :n] = np.asarray(g)
        mask[i, :n] = True

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    R0 = dev(np.stack([p[0] for p in poses]))
    t0 = dev(np.stack([p[1] for p in poses]))
    board3, uv = dev(board3), dev(uv)
    mask = torch.as_tensor(mask, device=device)
    p9 = dev(params9)
    eps = torch.zeros((V, 6), dtype=torch.float32, device=device)

    lam = 1e-3
    n_meas = float(2 * mask.sum())
    c0, n0 = _cost_at(p9, eps, R0, t0, board3, uv, mask)
    cost, n_active = float(c0), float(n0)
    for it in range(n_iters):
        accepted = False
        for _ in range(6):
            dc, dp, _ = _lm_step(p9, eps, lam, R0, t0, board3, uv, mask)
            p9_n, eps_n = p9 + dc, eps + dp
            c_t, n_t = _cost_at(p9_n, eps_n, R0, t0, board3, uv, mask)
            c_new, n_new = float(c_t), float(n_t)
            # a step that drops measurements from the active set is no
            # improvement, whatever its cost
            if np.isfinite(c_new) and c_new < cost and n_new >= n_active:
                p9, eps, cost, n_active = p9_n, eps_n, c_new, n_new
                lam = max(lam * 0.3, 1e-9)
                accepted = True
                break
            lam *= 10.0
        if verbose:
            print(f"LM iter {it}: rms {np.sqrt(cost / n_meas):.4f} px "
                  f"lam {lam:.1e} accepted={accepted}")
        if not accepted and lam > 1e8:
            break

    out_poses = []
    for i, (R_i, t_i) in enumerate(poses):
        Rw = _rodrigues_j(eps[i, :3]).cpu().numpy().astype(np.float64)
        out_poses.append((Rw @ np.asarray(R_i),
                          np.asarray(t_i) + eps[i, 3:].cpu().numpy().astype(np.float64)))
    rms = float(np.sqrt(cost / n_meas))
    return p9.cpu().numpy().astype(np.float64), out_poses, rms
