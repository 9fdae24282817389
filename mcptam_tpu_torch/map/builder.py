"""Map insertions: committing keyframes, points and measurements (port of
mcptam_tpu/map/builder.py; ref Map::AddPoint, MultiKeyFrame construction,
KeyFrame::AddMeasurement).

The JAX versions are pure functions; these write the new slots into the
given MapState in place and return it.
"""

from __future__ import annotations

import torch

from mcptam_tpu_torch.config import SRC_WINDOW
from mcptam_tpu_torch.core.camera import CameraModel, unproject
from mcptam_tpu_torch.core.levels import level_zero_pos
from mcptam_tpu_torch.core.se3 import SE3
from mcptam_tpu_torch.map.keyframe import FrameFeatures
from mcptam_tpu_torch.map.state import (
    MapState, SRC_ROOT, alloc_slots, refresh_pixel_vectors,
)
from mcptam_tpu_torch.ops.batch_patch import _SRC_HALF, gather_windows4


def commit_mkf(ms: MapState, feats: FrameFeatures, base_from_world: SE3,
               kf_valid=None, fixed=False):
    """Write a frame into the first free MKF slot (uint8 pyramid + corner
    atlases, SBI and gradients, base pose).  Returns (ms, idx, ok); with no
    free slot nothing is written."""
    mkfs = ms.mkfs
    C = mkfs.kf_valid.shape[1]
    free = ~mkfs.valid
    idx = torch.argmax(free.to(torch.int32))    # first free slot
    ok = torch.any(free)
    if kf_valid is None:
        kf_valid = torch.ones(C, dtype=torch.bool, device=free.device)

    def set_at(arr, val):
        arr[idx] = torch.where(ok, torch.as_tensor(val, device=arr.device).to(arr.dtype), arr[idx])

    set_at(mkfs.base_from_world.R, base_from_world.R)
    set_at(mkfs.base_from_world.t, base_from_world.t)
    mkfs.valid[idx] = ok | mkfs.valid[idx]
    set_at(mkfs.fixed, fixed)
    set_at(mkfs.kf_valid, kf_valid)
    set_at(mkfs.atlas, torch.clamp(feats.atlas, 0, 255))
    set_at(mkfs.corner_atlas, feats.corner_atlas > 0.5)
    set_at(mkfs.sbi, feats.sbi)
    set_at(mkfs.sbi_gx, feats.sbi_gx)
    set_at(mkfs.sbi_gy, feats.sbi_gy)
    set_at(mkfs.seq, ms.next_seq)
    ms.next_seq = ms.next_seq + 1
    return ms, idx, ok


def _masked_scatter(arr, slot, ok, val):
    """arr[slot[i]] = val[i] for the placed items only.  Unplaced items
    share slot 0 of the free list with the first placed one; they write
    to a dump row past the end instead, so the result is independent of
    scatter order and no host sync picks the placed items."""
    n = arr.shape[0]
    ext = torch.cat([arr, arr[:1]])
    ext[torch.where(ok, slot.to(torch.int64), n)] = val.to(arr.dtype)
    arr.copy_(ext[:n])


def add_points(ms: MapState, cams: CameraModel, mkf_idx, cam_idx, level,
               xy_level, pos_w, want, fixed=None):
    """Create up to Q points sourced in keyframe ``mkf_idx``: camera,
    pyramid level and level coords of each patch centre, world positions,
    and which requests are real.  Sets the patch-warp metadata, snapshots
    the source patch window and appends a ROOT measurement per point.
    Returns (ms, slot_idx, ok)."""
    pts = ms.points
    Q = want.shape[0]
    dev = want.device
    slot, ok = alloc_slots(~pts.valid, want)

    cam_q = cams[cam_idx.long()]
    lvlf = level.to(torch.float32)
    xy0 = level_zero_pos(xy_level, lvlf[:, None])
    scale = torch.exp2(lvlf)
    zero = torch.zeros(Q, device=dev)
    center_nc = unproject(cam_q, xy0)
    right_nc = unproject(cam_q, xy0 + torch.stack([scale, zero], -1))
    down_nc = unproject(cam_q, xy0 + torch.stack([zero, scale], -1))
    if fixed is None:
        fixed = torch.zeros(Q, dtype=torch.bool, device=dev)

    # snapshot the (immutable) source patch window from the committed
    # keyframe, so template generation never needs the keyframe store
    mkf_q = torch.as_tensor(mkf_idx, device=dev).to(torch.int64).expand(Q)
    cxi = torch.floor(xy_level[:, 0]).to(torch.int64)
    cyi = torch.floor(xy_level[:, 1]).to(torch.int64)
    src_win, win_ok = gather_windows4(
        ms.mkfs.atlas, mkf_q, cam_idx.to(torch.int64), level.to(torch.int64),
        cyi - _SRC_HALF, cxi - _SRC_HALF, SRC_WINDOW,
    )

    _masked_scatter(pts.pos_w, slot, ok, pos_w)
    _masked_scatter(pts.src_window, slot, ok, torch.clamp(src_win, 0, 255))
    _masked_scatter(pts.src_window_ok, slot, ok, win_ok)
    _masked_scatter(pts.valid, slot, ok, ok)
    _masked_scatter(pts.bad, slot, ok, torch.zeros(Q, dtype=torch.bool, device=dev))
    _masked_scatter(pts.fixed, slot, ok, fixed)
    _masked_scatter(pts.optimized, slot, ok, torch.zeros(Q, dtype=torch.bool, device=dev))
    _masked_scatter(pts.src_mkf, slot, ok, mkf_q)
    _masked_scatter(pts.src_cam, slot, ok, cam_idx)
    _masked_scatter(pts.src_level, slot, ok, level)
    _masked_scatter(pts.center_xy, slot, ok, xy_level.to(torch.float32))
    _masked_scatter(pts.center_nc, slot, ok, center_nc)
    _masked_scatter(pts.right_nc, slot, ok, right_nc)
    _masked_scatter(pts.down_nc, slot, ok, down_nc)
    _masked_scatter(pts.in_count, slot, ok, torch.zeros(Q, dtype=torch.int32, device=dev))
    _masked_scatter(pts.out_count, slot, ok, torch.zeros(Q, dtype=torch.int32, device=dev))

    ms = add_measurements(
        ms, mkf=mkf_q, cam=cam_idx, point=slot, level=level, uv_l0=xy0,
        want=ok, source=torch.full((Q,), SRC_ROOT, device=dev),
        subpix=torch.ones(Q, dtype=torch.bool, device=dev),
    )
    return refresh_pixel_vectors(ms), slot, ok


def add_measurements(ms: MapState, mkf, cam, point, level, uv_l0, want,
                     source, subpix):
    """Append measurements into free slots (masked)."""
    meas = ms.meas
    slot, ok = alloc_slots(~meas.valid, want)
    _masked_scatter(meas.mkf, slot, ok, mkf)
    _masked_scatter(meas.cam, slot, ok, cam)
    _masked_scatter(meas.point, slot, ok, point)
    _masked_scatter(meas.level, slot, ok, level)
    _masked_scatter(meas.uv_l0, slot, ok, uv_l0)
    _masked_scatter(meas.valid, slot, ok, ok)
    _masked_scatter(meas.source, slot, ok, source)
    _masked_scatter(meas.subpix, slot, ok, subpix)
    return ms
