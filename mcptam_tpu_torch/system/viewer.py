"""Headless visualisation: the KeyFrameViewer and rviz-publishing analogue
(port of mcptam_tpu/system/viewer.py; host numpy over copies of the
device tensors).

The reference draws keyframes with per-level coloured measurements in a
GL window (KeyFrameViewer.h:57-89) and publishes the map as a point cloud
with MKF markers (MapMakerBase::PublishMapVisualization,
src/MapMakerBase.cc:359-472).  Here: PPM images with measurement
overlays, and an ASCII PLY of the map that any point-cloud viewer opens.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mcptam_tpu_torch.config import LEVELS
from mcptam_tpu_torch.map.state import MapState
from mcptam_tpu_torch.ops.atlas import _level0_width_from_atlas, atlas_xoff, level_dims

# per-level overlay colours, as the reference's level colours
LEVEL_COLORS = ((255, 0, 0), (255, 255, 0), (0, 255, 0), (0, 0, 255))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def write_ppm(path: str, rgb: np.ndarray):
    """(H,W,3) uint8 -> binary PPM."""
    H, W, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{W} {H}\n255\n".encode())
        f.write(np.ascontiguousarray(rgb, np.uint8).tobytes())


def _draw_cross(rgb, x, y, color, r=2):
    H, W, _ = rgb.shape
    xi, yi = int(round(x)), int(round(y))
    if not (0 <= xi < W and 0 <= yi < H):
        return
    rgb[yi, max(0, xi - r): min(W, xi + r + 1)] = color
    rgb[max(0, yi - r): min(H, yi + r + 1), xi] = color


def keyframe_overlay(ms: MapState, mkf_idx: int, cam_idx: int) -> np.ndarray:
    """One stored keyframe with its measurements overlaid
    (KeyFrameViewer::Draw analogue) -> (H,W,3) uint8."""
    atlas = _np(ms.mkfs.atlas[mkf_idx, cam_idx])
    W = _level0_width_from_atlas(atlas.shape[1])
    img = np.clip(atlas[:, :W], 0, 255).astype(np.uint8)
    rgb = np.stack([img] * 3, axis=-1)
    meas = ms.meas
    sel = _np(meas.valid) & (_np(meas.mkf) == mkf_idx) & (_np(meas.cam) == cam_idx)
    for (x, y), l in zip(_np(meas.uv_l0)[sel], _np(meas.level)[sel]):
        _draw_cross(rgb, x, y, LEVEL_COLORS[int(l) % LEVELS])
    return rgb


def dump_keyframes(ms: MapState, out_dir: str, max_mkfs: int | None = None):
    """Write every valid keyframe camera as <out_dir>/mkf<i>_cam<c>.ppm;
    returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    valid, kf_valid = _np(ms.mkfs.valid), _np(ms.mkfs.kf_valid)
    count, paths = 0, []
    for m in range(ms.mkfs.capacity):
        if not valid[m]:
            continue
        for c in range(kf_valid.shape[1]):
            if not kf_valid[m, c]:
                continue
            p = os.path.join(out_dir, f"mkf{m}_cam{c}.ppm")
            write_ppm(p, keyframe_overlay(ms, m, c))
            paths.append(p)
        count += 1
        if max_mkfs and count >= max_mkfs:
            break
    return paths


def export_ply(path: str, ms: MapState, trajectory=None) -> int:
    """Live map points coloured by level, MKF centres in white and an
    optional (T,3) trajectory in magenta, as ASCII PLY; returns the vertex
    count."""
    pts = ms.points
    live = _np(pts.valid & ~pts.bad)
    pos = _np(pts.pos_w)[live]
    lvl = _np(pts.src_level)[live]
    colors = (np.asarray([LEVEL_COLORS[int(l) % LEVELS] for l in lvl], np.uint8)
              if len(lvl) else np.zeros((0, 3), np.uint8))
    # MKF centres: -R^T t of base_from_world
    bfw_R, bfw_t = _np(ms.mkfs.base_from_world.R), _np(ms.mkfs.base_from_world.t)
    mvalid = _np(ms.mkfs.valid)
    centers = (np.stack([-bfw_R[m].T @ bfw_t[m] for m in range(len(mvalid)) if mvalid[m]])
               if mvalid.any() else np.zeros((0, 3)))
    traj = np.asarray(trajectory) if trajectory is not None else np.zeros((0, 3))

    n = len(pos) + len(centers) + len(traj)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, c in zip(pos, colors):
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} {c[0]} {c[1]} {c[2]}\n")
        for p in centers:
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} 255 255 255\n")
        for p in traj:
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} 255 0 255\n")
    return n


def frame_small_image(feats, result=None, level: int = 2) -> np.ndarray:
    """Tiled per-camera monitor image at a pyramid level, two columns, with
    the frame's found measurements overlaid (ref PublishSmallImage,
    src/SystemFrontendBase.cc:280-346) -> (Ht,Wt,3) uint8."""
    C, H, AW = feats.atlas.shape
    W = _level0_width_from_atlas(AW)
    level = int(level) % LEVELS
    h, w = level_dims(H, W, level)
    xoff = atlas_xoff(W)[level]
    atlas = _np(feats.atlas[:, :h, xoff:xoff + w])
    scale = 1 << level

    cols = 2 if C > 1 else 1
    rows = -(-C // cols)
    tiled = np.zeros((rows * h, cols * w, 3), np.uint8)
    for c in range(C):
        img = np.clip(atlas[c], 0, 255).astype(np.uint8)
        r0, c0 = (c // cols) * h, (c % cols) * w
        tiled[r0:r0 + h, c0:c0 + w] = img[..., None]

    if result is not None:
        found = _np(result.sel_found)
        cam, lvl = _np(result.sel_cam)[found], _np(result.sel_level)[found]
        uv = _np(result.sel_pos_l0)[found] / scale
        for (x, y), c, l in zip(uv, cam, lvl):
            r0, c0 = (int(c) // cols) * h, (int(c) % cols) * w
            _draw_cross(tiled, c0 + x, r0 + y, LEVEL_COLORS[int(l) % LEVELS], r=1)
    return tiled
