"""Synthetic checkerboard rendering and ground truth for calibration
(port of mcptam_tpu/calib/board.py).

The reference is driven by live checkerboard video; the oracle renders a
planar board through the Taylor camera at known poses, so detection,
intrinsic and extrinsic calibration can be checked against exact
parameters."""

from __future__ import annotations

import numpy as np
import torch

from mcptam_tpu_torch.core.camera import CameraModel, project, unproject
from mcptam_tpu_torch.core.se3 import SE3
from mcptam_tpu_torch.ops.pyramid import gaussian_blur_3


def render_checkerboard(cam: CameraModel, board_from_cam: SE3,
                        H: int, W: int, squares=(8, 6),
                        square_size: float = 0.04,
                        background: float = 128.0) -> torch.Tensor:
    """An (H,W) f32 image of a checkerboard plane (z=0 in the board frame)
    on the camera's device.  The board spans [0, squares[0]*s] x
    [0, squares[1]*s]; outside it the image is flat background."""
    dev = cam.center.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    rays = unproject(cam, torch.stack([xs, ys], -1))          # cam frame
    Rb, tb = board_from_cam.R, board_from_cam.t
    dz = torch.einsum("j,hwj->hw", Rb[2], rays)
    t_star = -tb[2] / torch.where(torch.abs(dz) < 1e-9, torch.full_like(dz, 1e-9), dz)
    q = torch.einsum("ij,hwj->hwi", Rb, rays * t_star[..., None]) + tb
    gx = q[..., 0] / square_size
    gy = q[..., 1] / square_size
    inside = ((t_star > 0) & (gx >= 0) & (gx <= squares[0])
              & (gy >= 0) & (gy <= squares[1]))
    checker = (torch.floor(gx).to(torch.int32) + torch.floor(gy).to(torch.int32)) % 2
    color = torch.where(checker == 0, torch.full_like(gx, 235.0),
                        torch.full_like(gx, 20.0))
    img = torch.where(inside, color, torch.full_like(gx, background))
    # a slight blur softens the edges (sub-pixel refinement needs it)
    return gaussian_blur_3(img, sigma=0.8, radius=2)


def inner_corner_points(squares=(8, 6), square_size: float = 0.04) -> np.ndarray:
    """Board-frame coordinates of the inner corners, row-major (r,c):
    (n_rows, n_cols, 3) with n_cols = squares[0]-1, n_rows = squares[1]-1."""
    nc, nr = squares[0] - 1, squares[1] - 1
    pts = np.zeros((nr, nc, 3))
    for r in range(nr):
        for c in range(nc):
            pts[r, c] = [(c + 1) * square_size, (r + 1) * square_size, 0.0]
    return pts


def project_corners(cam: CameraModel, board_from_cam: SE3, squares=(8, 6),
                    square_size: float = 0.04):
    """Ground-truth projections of the inner corners: ((nr,nc,2), valid)."""
    pts = torch.as_tensor(inner_corner_points(squares, square_size),
                          dtype=torch.float32, device=cam.center.device)
    cam_pts = board_from_cam.inv().apply(pts.reshape(-1, 3))
    uv, ok = project(cam, cam_pts)
    nr, nc, _ = pts.shape
    return uv.reshape(nr, nc, 2), ok.reshape(nr, nc)
