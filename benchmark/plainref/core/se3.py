"""Batched SE(3)/SO(3) operations (port of mcptam_tpu/core/se3.py).

Conventions as the reference (TooN): a 6-vector tangent is ``[u, w]``,
translation first; pose updates are left-multiplied; an ``SE3`` maps points
into its frame, ``x_out = R @ x_in + t``.  Everything broadcasts over
leading batch dimensions; small-angle cases use the reference's series
branches and thresholds.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of (...,3) -> (...,3,3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zero, -wz, wy], -1),
        torch.stack([wz, zero, -wx], -1),
        torch.stack([-wy, wx, zero], -1),
    ], -2)


def vee(W: torch.Tensor) -> torch.Tensor:
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def _sinc_coeffs(theta_sq: torch.Tensor):
    """(sin t/t, (1-cos t)/t^2, (t-sin t)/t^3) with the reference's series
    below theta^2 = 1e-2 (the closed forms cancel in f32 there)."""
    theta = torch.sqrt(torch.clamp(theta_sq, min=0.0))
    small = theta_sq < 1e-2
    ts = torch.where(small, torch.ones_like(theta), theta)
    t2 = theta_sq
    A = torch.where(small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0, torch.sin(ts) / ts)
    t2_safe = torch.where(small, torch.ones_like(t2), t2)
    B = torch.where(small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0,
                    (1.0 - torch.cos(ts)) / t2_safe)
    C = torch.where(small, 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0,
                    (1.0 - A) / t2_safe)
    return A, B, C


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (...,3) -> (...,3,3)."""
    A, B, _ = _sinc_coeffs(torch.sum(w * w, -1))
    W = hat(w)
    W2 = W @ W
    return _eye_like(W) + A[..., None, None] * W + B[..., None, None] * W2


def so3_ln(R: torch.Tensor) -> torch.Tensor:
    """Log map (...,3,3) -> (...,3), including rotations near pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    s = vee(R - R.transpose(-1, -2)) * 0.5
    sin_t = torch.linalg.vector_norm(s, dim=-1)
    theta = torch.atan2(sin_t, cos_t)

    small = sin_t < _EPS
    sin_safe = torch.where(small, torch.ones_like(sin_t), sin_t)
    factor = torch.where(small, 1.0 + theta * theta / 6.0, theta / sin_safe)
    w_regular = factor[..., None] * s

    near_pi = cos_t < -0.999
    Rp = R + torch.eye(3, dtype=R.dtype, device=R.device)
    diag = torch.stack([Rp[..., 0, 0], Rp[..., 1, 1], Rp[..., 2, 2]], -1)
    k = torch.argmax(diag, -1)
    col = torch.gather(
        Rp, -1, k[..., None, None].expand(Rp.shape[:-1] + (1,))
    )[..., 0]
    col_norm = torch.linalg.vector_norm(col, dim=-1, keepdim=True)
    axis = col / torch.where(col_norm < _EPS, torch.ones_like(col_norm), col_norm)
    sign = torch.where(torch.sum(axis * s, -1, keepdim=True) < 0, -1.0, 1.0)
    w_pi = theta[..., None] * axis * sign
    return torch.where(near_pi[..., None], w_pi, w_regular)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (...,i,j) x (...,j) -> (...,i)."""
    return (M @ v[..., None])[..., 0]


@dataclass
class SE3:
    """Rigid transform ``x_out = R @ x_in + t`` with leading batch dims."""

    R: torch.Tensor  # (...,3,3)
    t: torch.Tensor  # (...,3)

    @classmethod
    def identity(cls, batch_shape=(), device="cpu") -> "SE3":
        R = torch.eye(3, device=device).expand(tuple(batch_shape) + (3, 3)).clone()
        t = torch.zeros(tuple(batch_shape) + (3,), device=device)
        return cls(R=R, t=t)

    @classmethod
    def exp(cls, v6: torch.Tensor) -> "SE3":
        """Tangent (...,6) = [u, w] -> SE3 with t = V @ u."""
        u, w = v6[..., :3], v6[..., 3:]
        A, B, C = _sinc_coeffs(torch.sum(w * w, -1))
        W = hat(w)
        W2 = W @ W
        eye = _eye_like(W)
        R = eye + A[..., None, None] * W + B[..., None, None] * W2
        V = eye + B[..., None, None] * W + C[..., None, None] * W2
        return cls(R=R, t=_mv(V, u))

    def __matmul__(self, other: "SE3") -> "SE3":
        return SE3(R=self.R @ other.R, t=_mv(self.R, other.t) + self.t)

    def inv(self) -> "SE3":
        Rt = self.R.transpose(-1, -2)
        return SE3(R=Rt, t=-_mv(Rt, self.t))

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Transform points (...,3); the pose broadcasts against x."""
        return torch.einsum("...ij,...j->...i", self.R, x) + self.t

    def ln(self) -> torch.Tensor:
        """Log map -> (...,6) = [u, w]."""
        w = so3_ln(self.R)
        theta_sq = torch.sum(w * w, -1)
        A, B, _ = _sinc_coeffs(theta_sq)
        W = hat(w)
        W2 = W @ W
        small = theta_sq < 1e-2
        ts_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
        coef = torch.where(
            small,
            1.0 / 12.0 + theta_sq / 720.0 + theta_sq * theta_sq / 30240.0,
            (1.0 - A / (2.0 * B)) / ts_safe,
        )
        Vinv = _eye_like(W) - 0.5 * W + coef[..., None, None] * W2
        return torch.cat([_mv(Vinv, self.t), w], -1)

    def __getitem__(self, idx) -> "SE3":
        return SE3(R=self.R[idx], t=self.t[idx])


def geodesic_rotation_mean(Rs: torch.Tensor, mask: torch.Tensor,
                           iters: int = 10) -> torch.Tensor:
    """Geodesic L2 mean of rotations (N,3,3) under a validity mask (N,),
    fixed iteration count (ref rotation averaging, src/Tracker.cc:1687-1749)."""
    denom = torch.clamp(torch.sum(mask), min=1.0)
    R_mean = torch.eye(3, dtype=Rs.dtype, device=Rs.device)
    for _ in range(iters):
        rel = R_mean.T @ Rs
        tangents = so3_ln(rel) * mask[:, None]
        delta = torch.sum(tangents, 0) / denom
        R_mean = R_mean @ so3_exp(delta)
    return R_mean
