"""SmallBlurryImage: 40x30 ESM alignment for the tracker's rotation
estimate (port of the tracking subset of mcptam_tpu/ops/sbi.py, ref
src/SmallBlurryImage.cc).

``esm_align`` is the plain version of the ESM kernel (csrc/esm.cu), batched
over a leading camera axis.  SE2 state is (cos, sin, tx, ty).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from plainref.config import SBI_SIZE
from plainref.core.camera import (
    CameraModel, project, projection_derivs_sphere, unproject, cam_sphere_deriv,
)
from plainref.core.linalg import solve_spd
from plainref.core.se3 import so3_exp
from plainref.ops.pyramid import gaussian_blur_3, half_sample

ROWS, COLS = SBI_SIZE
CENTER = (COLS // 2, ROWS // 2)  # (x, y) = (20, 15)
DEFAULT_BLUR = 2.5


@functools.lru_cache(maxsize=16)
def _linear_resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) weights of ``jax.image.resize(..., "linear")`` along
    one axis (jax/_src/image/scale.py::compute_weight_mat, antialias on,
    no translation): a triangle kernel at half-pixel centres, widened by
    1/scale when downsampling, each output sample's weights normalised to
    sum 1, zero where the sample falls outside the input.  Computed in
    f32 as the reference computes it; cached per device."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.as_tensor(np.where(inside[None, :], w, f32(0.0)).astype(f32),
                           device=device)


def make_sbi(img_l0: torch.Tensor) -> torch.Tensor:
    """(...,H,W) level-0 image -> (...,30,40) zero-mean blurred template
    (ref MakeFromKF, src/SmallBlurryImage.cc:67-95) by a chain of 2x2
    half-samples; where the chain does not end at 30x40 (a 480x752 camera
    stops at 30x47), the reference's linear resize finishes it: one
    weight matrix per axis whose size differs, applied by einsum."""
    small = img_l0
    while (
        small.shape[-2] % 2 == 0 and small.shape[-2] // 2 >= ROWS
        and small.shape[-1] % 2 == 0 and small.shape[-1] // 2 >= COLS
    ):
        small = half_sample(small)
    h, w = small.shape[-2:]
    if h != ROWS:
        small = torch.einsum("...hw,hr->...rw", small,
                             _linear_resize_weights(h, ROWS, small.device))
    if w != COLS:
        small = torch.einsum("...hw,wc->...hc", small,
                             _linear_resize_weights(w, COLS, small.device))
    centered = small - torch.mean(small, (-2, -1), keepdim=True)
    return gaussian_blur_3(centered, sigma=DEFAULT_BLUR, radius=4)


def sbi_zmssd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of squared differences of already zero-mean templates
    (broadcasts; reduces over the trailing two axes)."""
    return torch.sum((a - b) ** 2, (-2, -1))


def sbi_gradients(template: torch.Tensor):
    """Unscaled central-difference gradients, zero at the borders."""
    gx = torch.zeros_like(template)
    gy = torch.zeros_like(template)
    gx[..., 1:-1, 1:-1] = template[..., 1:-1, 2:] - template[..., 1:-1, :-2]
    gy[..., 1:-1, 1:-1] = template[..., 2:, 1:-1] - template[..., :-2, 1:-1]
    return gx, gy


def esm_align(cur, target, target_gx, target_gy, n_iterations: int = 9):
    """ESM-align each camera's ``cur`` (C,30,40) to ``target`` (ref
    IteratePosRelToTarget, src/SmallBlurryImage.cc:138-248).

    Returns (se2 (C,4) = (cos, sin, tx, ty), score (C,)): the SE2 transform
    in centred pixel coords and the last iteration's SSD over valid pixels."""
    C = cur.shape[0]
    dev = cur.device
    ys = torch.arange(ROWS, dtype=torch.float32, device=dev)[:, None].expand(ROWS, COLS)
    xs = torch.arange(COLS, dtype=torch.float32, device=dev)[None, :].expand(ROWS, COLS)
    cx, cy = float(CENTER[0]), float(CENTER[1])
    row_ids = torch.arange(ROWS, dtype=torch.float32, device=dev)
    col_ids = torch.arange(COLS, dtype=torch.float32, device=dev)
    inner = torch.zeros((ROWS, COLS), dtype=torch.bool, device=dev)
    inner[1:-1, 1:-1] = True

    c = torch.ones(C, device=dev)
    s = torch.zeros(C, device=dev)
    tx = torch.zeros(C, device=dev)
    ty = torch.zeros(C, device=dev)
    mean_offset = torch.zeros(C, device=dev)
    score = torch.full((C,), float("inf"), device=dev)
    eye4 = torch.eye(4, device=dev)
    for _ in range(n_iterations):
        c3, s3 = c[:, None, None], s[:, None, None]
        xr = c3 * (xs - cx) - s3 * (ys - cy) + cx + tx[:, None, None]
        yr = s3 * (xs - cx) + c3 * (ys - cy) + cy + ty[:, None, None]
        xrc = torch.clamp(xr, 0.0, COLS - 1.0)
        yrc = torch.clamp(yr, 0.0, ROWS - 1.0)
        # bilinear sampling by hat-function weights over the index grids
        hy = torch.clamp(1.0 - torch.abs(yrc[..., None] - row_ids), min=0.0)
        hx = torch.clamp(1.0 - torch.abs(xrc[..., None] - col_ids), min=0.0)
        z = torch.einsum("nrcb,nab->nrca", hx, cur)              # (C,R,Cc,ROWS)
        warped = torch.sum(hy * z, -1)
        valid_src = (xr >= 0) & (xr <= COLS - 2) & (yr >= 0) & (yr <= ROWS - 2)
        wgx = torch.zeros_like(warped)
        wgy = torch.zeros_like(warped)
        wgx[:, 1:-1, 1:-1] = warped[:, 1:-1, 2:] - warped[:, 1:-1, :-2]
        wgy[:, 1:-1, 1:-1] = warped[:, 2:, 1:-1] - warped[:, :-2, 1:-1]
        nb_valid = (
            valid_src
            & torch.roll(valid_src, 1, 2) & torch.roll(valid_src, -1, 2)
            & torch.roll(valid_src, 1, 1) & torch.roll(valid_src, -1, 1)
        )
        m = (inner & nb_valid).to(warped.dtype)

        gx = 0.25 * (wgx + target_gx)
        gy = 0.25 * (wgy + target_gy)
        j3 = -(ys - cy) * gx + (xs - cx) * gy
        diff = (warped - target + mean_offset[:, None, None]) * m
        J = torch.stack([gx * m, gy * m, j3 * m, m], -1).reshape(C, -1, 4)
        H = J.transpose(1, 2) @ J
        b = (J.transpose(1, 2) @ diff.reshape(C, -1, 1))[..., 0]
        upd = solve_spd(H + 1e-6 * eye4, b)
        score = torch.sum(diff * diff, (1, 2))

        dth = -upd[:, 2]
        cu, su, ux, uy = torch.cos(dth), torch.sin(dth), -upd[:, 0], -upd[:, 1]
        c, s, tx, ty = (c * cu - s * su, s * cu + c * su,
                        c * ux - s * uy + tx, s * ux + c * uy + ty)
        mean_offset = mean_offset - upd[:, 3]
    return torch.stack([c, s, tx, ty], -1), score


def se3_from_se2(se2: torch.Tensor, cam_src_sbi: CameraModel,
                 cam_target_sbi: CameraModel) -> torch.Tensor:
    """Lift per-camera SBI SE2s (C,4) to camera-frame rotations (C,3,3) by
    2-point reprojection WLS (ref SE3fromSE2, src/SmallBlurryImage.cc:
    253-313).  The cameras are SBI-sized, with batch shape (C,).

    Returns R taking target-frame rays to source-frame rays."""
    C = se2.shape[0]
    dev = se2.device
    c, s, tx, ty = se2[:, 0], se2[:, 1], se2[:, 2], se2[:, 3]
    ar = torch.arange(2, dtype=torch.float32, device=dev)
    center = float(CENTER[0]) + (float(CENTER[1]) - float(CENTER[0])) * ar
    p5 = 5.0 - 5.0 * ar   # (5, 0), built without a host copy
    turned = torch.stack([
        center + torch.stack([c * 5.0 + tx, s * 5.0 + ty], -1),
        center + torch.stack([-c * 5.0 + tx, -s * 5.0 + ty], -1),
    ], 1)                                                        # (C,2,2)
    orig = unproject(cam_target_sbi[:, None],
                     torch.stack([center + p5, center - p5])[None])  # (C,2,3)
    src = cam_src_sbi[:, None]
    eye3 = torch.eye(3, device=dev)
    R = eye3.expand(C, 3, 3)
    for _ in range(3):
        v3cam = torch.einsum("cij,cnj->cni", R, orig)
        uv, _ = project(src, v3cam)
        err = turned - uv
        duv = projection_derivs_sphere(src, v3cam)               # (C,2,2,2)
        d_th, d_ph = cam_sphere_deriv(v3cam)                     # (C,2,3)
        zero = torch.zeros_like(v3cam[..., 0])
        gens = torch.stack([
            torch.stack([zero, -v3cam[..., 2], v3cam[..., 1]], -1),
            torch.stack([v3cam[..., 2], zero, -v3cam[..., 0]], -1),
            torch.stack([-v3cam[..., 1], v3cam[..., 0], zero], -1),
        ], 2)                                                    # (C,2,3gen,3)
        sph = torch.stack([
            torch.einsum("cnd,cngd->cng", d_th, gens),
            torch.einsum("cnd,cngd->cng", d_ph, gens),
        ], 2)                                                    # (C,2,2,3)
        Jf = (duv @ sph).reshape(C, 4, 3)
        ef = err.reshape(C, 4)
        H = Jf.transpose(1, 2) @ Jf + 10.0 * eye3
        mu = solve_spd(H, (Jf.transpose(1, 2) @ ef[..., None])[..., 0])
        R = so3_exp(mu) @ R
    return R
