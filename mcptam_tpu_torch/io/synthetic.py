"""Synthetic multi-camera scene: ground-truth replay harness (port of
mcptam_tpu/io/synthetic.py).

A procedurally textured sphere rendered through the Taylor camera model
gives multi-view-consistent images with exact ground-truth poses and
depths for any rig trajectory; the pose-calibration world adds an opaque
checkerboard on the world z=0 plane (``render_view_board``).  The texture hashes ``sin(h)*43758.5453``,
so one ulp of ``sin`` moves a pixel by ~1e-3 grey levels' worth of hash:
renders agree with the JAX package's within a few grey levels, not bit for
bit.
"""

from __future__ import annotations

import numpy as np
import torch

from mcptam_tpu_torch.config import LEVELS, SBI_SIZE
from mcptam_tpu_torch.core.camera import (
    CameraModel, make_camera, stack_cameras, unproject,
)
from mcptam_tpu_torch.core.levels import level_zero_pos
from mcptam_tpu_torch.core.se3 import SE3
from mcptam_tpu_torch.ops.pyramid import gaussian_blur_3

SPHERE_RADIUS = 6.0

# default fisheye intrinsics for tests/benchmarks (realistic wide lens)
DEFAULT_PARAMS = np.array(
    [180.0, -0.0020, 1.2e-6, -2.0e-9, 322.0, 243.0, 1.001, 0.0003, -0.0002]
)


def _hash3(ix, iy, iz, seed: float):
    h = ix * 12.9898 + iy * 78.233 + iz * 37.719 + seed * 4.1459
    return torch.remainder(torch.abs(torch.sin(h) * 43758.5453), 1.0)


def value_noise3(p, freq: float, seed: float):
    """Trilinear-interpolated lattice noise at points (...,3)."""
    q = p * freq
    q0 = torch.floor(q)
    f = q - q0
    f = f * f * (3.0 - 2.0 * f)  # smoothstep
    ix, iy, iz = q0[..., 0], q0[..., 1], q0[..., 2]
    out = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                v = _hash3(ix + dx, iy + dy, iz + dz, seed)
                w = ((f[..., 0] if dx else 1 - f[..., 0])
                     * (f[..., 1] if dy else 1 - f[..., 1])
                     * (f[..., 2] if dz else 1 - f[..., 2]))
                out = out + v * w
    return out


def texture(p, seed: float = 1.0):
    """Multi-octave intensity in [0,255] at world points (...,3)."""
    v = (0.55 * value_noise3(p, 1.3, seed)
         + 0.3 * value_noise3(p, 4.1, seed + 1.0)
         + 0.15 * value_noise3(p, 11.7, seed + 2.0))
    return torch.clamp(v * 255.0, 0.0, 255.0)


def render_view(cam: CameraModel, cam_from_world: SE3, seed: float,
                H: int, W: int) -> torch.Tensor:
    """Render one camera view (H,W) f32 on the camera's device."""
    dev = cam.center.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    rays_c = unproject(cam, torch.stack([xs, ys], -1))          # (H,W,3)
    w_from_c = cam_from_world.inv()
    d = torch.einsum("ij,hwj->hwi", w_from_c.R, rays_c)
    c = w_from_c.t
    b = torch.einsum("hwi,i->hw", d, c)
    disc = b * b - (torch.dot(c, c) - SPHERE_RADIUS ** 2)
    t = -b + torch.sqrt(torch.clamp(disc, min=0.0))
    return texture(c + t[..., None] * d, seed)


def render_rig(cams: CameraModel, cam_from_base: SE3, base_from_world: SE3,
               seed: float, H: int, W: int) -> torch.Tensor:
    """Render all C cameras: (C,H,W) f32."""
    C = cam_from_base.t.shape[0]
    return torch.stack([
        render_view(cams[i], cam_from_base[i] @ base_from_world, seed, H, W)
        for i in range(C)
    ])


def render_view_board(cam: CameraModel, cam_from_world: SE3, seed: float,
                      H: int, W: int, squares=(8, 6),
                      square_size: float = 0.25) -> torch.Tensor:
    """One view of a world holding both the textured sphere and an opaque
    checkerboard on the world z=0 plane spanning [0, squares[0]*s] x
    [0, squares[1]*s]: the pose-calibration world, whose frame IS the
    board frame (the reference anchors the calibration map to the grid,
    src/MapMakerCalib.cc:72-90).  (H,W) f32 on the camera's device."""
    dev = cam.center.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    rays_c = unproject(cam, torch.stack([xs, ys], -1))
    w_from_c = cam_from_world.inv()
    d = torch.einsum("ij,hwj->hwi", w_from_c.R, rays_c)
    c = w_from_c.t
    b = torch.einsum("hwi,i->hw", d, c)
    disc = b * b - (torch.dot(c, c) - SPHERE_RADIUS ** 2)
    t_sph = -b + torch.sqrt(torch.clamp(disc, min=0.0))
    sphere_col = texture(c + t_sph[..., None] * d, seed)
    dz = torch.where(torch.abs(d[..., 2]) < 1e-9, torch.full_like(d[..., 2], 1e-9),
                     d[..., 2])
    t_pl = -c[2] / dz
    q = c + t_pl[..., None] * d
    gx = q[..., 0] / square_size
    gy = q[..., 1] / square_size
    on_board = ((t_pl > 1e-3) & (t_pl < t_sph) & (gx >= 0) & (gx <= squares[0])
                & (gy >= 0) & (gy <= squares[1]))

    # anti-aliased checker 0.5 (1 + sq(gx) sq(gy)), sq the period-2 square
    # wave box-filtered over each pixel's footprint through its
    # antiderivative, the period-2 triangle wave: point sampling would bake
    # in aliasing that caps sub-pixel matching near 0.4 px
    def tri(x):
        return 1.0 - torch.abs(torch.remainder(x, 2.0) - 1.0)

    def sq_filtered(g, w):
        w = torch.clamp(w, min=1e-4)
        return (tri(g + 0.5 * w) - tri(g - 0.5 * w)) / w

    def footprint(g):
        dgy, dgx = torch.gradient(g)
        return torch.abs(dgx) + torch.abs(dgy)

    sgn = sq_filtered(gx, footprint(gx)) * sq_filtered(gy, footprint(gy))
    img = torch.where(on_board, 127.5 + 107.5 * sgn, sphere_col)
    # optical blur, as render_checkerboard's: razor-sharp edges would make
    # a half-pixel misregistration blow the ZMSSD budget
    return gaussian_blur_3(img, sigma=1.0, radius=3)


def render_rig_board(cams: CameraModel, cam_from_base: SE3,
                     base_from_world: SE3, seed: float, H: int, W: int,
                     squares=(8, 6), square_size: float = 0.25) -> torch.Tensor:
    """All C cameras of the board-and-sphere world: (C,H,W) f32."""
    C = cam_from_base.t.shape[0]
    return torch.stack([
        render_view_board(cams[i], cam_from_base[i] @ base_from_world, seed, H, W,
                          squares, square_size)
        for i in range(C)
    ])


def ray_depth(cam_from_world: SE3, rays_c):
    """Ground-truth depth along camera rays to the sphere."""
    w_from_c = cam_from_world.inv()
    d = torch.einsum("ij,...j->...i", w_from_c.R, rays_c)
    c = w_from_c.t
    b = torch.einsum("...i,i->...", d, c)
    disc = b * b - (torch.dot(c, c) - SPHERE_RADIUS ** 2)
    return -b + torch.sqrt(torch.clamp(disc, min=0.0))


def make_rig(n_cams: int, H: int = 480, W: int = 640,
             spread_deg: float = 30.0, device="cuda"):
    """n identical fisheye cameras fanned out in yaw with decimetre
    baselines, like the reference's multi-camera clusters."""
    params = DEFAULT_PARAMS.copy()
    params[4] = W / 2.0 + 2.0
    params[5] = H / 2.0 + 3.0
    params[0] = 0.28 * W
    cams = stack_cameras([make_camera(params, (W, H), device=device)
                          for _ in range(n_cams)])
    yaws = (np.arange(n_cams) - (n_cams - 1) / 2.0) * np.radians(spread_deg)
    Rs, ts = [], []
    for i, y in enumerate(yaws):
        Rs.append(np.array([[np.cos(y), 0, -np.sin(y)], [0, 1, 0],
                            [np.sin(y), 0, np.cos(y)]], np.float32))
        ts.append(np.array([0.25 * (i % 2), -0.08 * i, 0.0], np.float32))
    cam_from_base = SE3(R=torch.as_tensor(np.stack(Rs), device=device),
                        t=torch.as_tensor(np.stack(ts), device=device))
    return cams, cam_from_base


def make_sbi_cams(cams: CameraModel, H: int, W: int) -> CameraModel:
    """SBI-sized (40x30) variants of the rig cameras: centres and affine
    scale linearly with image size."""
    dev = cams.center.device
    s = torch.tensor([SBI_SIZE[1] / W, SBI_SIZE[0] / H], device=dev)
    affine = cams.affine * s[:, None]
    C = cams.theta_mean.shape[0]
    return CameraModel(
        poly=cams.poly, poly_deriv_mod=cams.poly_deriv_mod,
        inv_poly=cams.inv_poly, theta_mean=cams.theta_mean,
        theta_std=cams.theta_std, center=cams.center * s, affine=affine,
        affine_inv=torch.linalg.inv(affine),
        image_size=torch.tensor([float(SBI_SIZE[1]), float(SBI_SIZE[0])],
                                device=dev).expand(C, 2).clone(),
        min_theta=cams.min_theta, max_rho=cams.max_rho,
        one_pixel_angle=cams.one_pixel_angle,
    )


def build_groundtruth_map(cams, cam_from_base, H, W, pose0=None,
                          seed: float = 3.0, n_per_level: int = 40,
                          max_points: int = 1024, max_mkfs: int = 8,
                          max_meas: int = 8192):
    """A MapState populated with exact-depth points from one rendered
    keyframe: the instant map for tests and benchmarks (bypasses the
    epipolar initialisation).  Returns (ms, feats)."""
    from mcptam_tpu_torch.map.builder import add_points, commit_mkf
    from mcptam_tpu_torch.map.keyframe import make_frame_features
    from mcptam_tpu_torch.map.state import create_map_state, refresh_scene_depths

    dev = cam_from_base.t.device
    if pose0 is None:
        pose0 = SE3.identity(device=dev)
    C = int(cam_from_base.t.shape[0])
    images = render_rig(cams, cam_from_base, pose0, seed, H, W)
    feats = make_frame_features(images)
    ms = create_map_state(H, W, C, cam_from_base, max_points, max_mkfs,
                          max_meas)
    ms, mkf_idx, _ = commit_mkf(ms, feats, pose0, fixed=True)
    for c in range(C):
        pose_c = cam_from_base[c] @ pose0
        for l in range(LEVELS):
            xy = feats.cand_xy[l][c][:n_per_level].to(torch.float32)
            want = feats.cand_valid[l][c][:n_per_level]
            rays = unproject(cams[c], level_zero_pos(xy, float(l)))
            depth = ray_depth(pose_c, rays)
            pos_w = pose_c.inv().apply(rays * depth[:, None])
            Q = xy.shape[0]
            ms, _, _ = add_points(
                ms, cams, mkf_idx=mkf_idx,
                cam_idx=torch.full((Q,), c, dtype=torch.int32, device=dev),
                level=torch.full((Q,), l, dtype=torch.int32, device=dev),
                xy_level=xy, pos_w=pos_w, want=want,
            )
    return refresh_scene_depths(ms), feats
