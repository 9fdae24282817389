"""Map-maker device work: map bootstrap, keyframe integration and the
tracker's add-MKF heuristic (port of mcptam_tpu/map/mapmaker_core.py, ref
src/MapMakerServerBase.cc).

``init_from_mkf`` is InitFromMultiKeyFrame (:146-261): the first MKF,
fixed, with stereo points between neighbouring cameras of a rig, or
fixed-depth points for one camera.  ``integrate_mkf_device`` is AddMultiKeyFrameAndCreatePoints (:346-404):
commit the keyframe imagery, record the tracker's measurements, refind
existing points in the new keyframes, then create points from its thinned
candidates, coarse levels first against the closest keyframes of OTHER
MKFs (the large-point sanity quantity), then the finer levels, then
against sibling keyframes of the same MKF.  Every pass runs and the host
decides acceptance afterwards, as in the reference.
"""

from __future__ import annotations

import torch

from mcptam_tpu_torch.config import DEFAULT_MAPMAKER, LEVELS, MapMakerConfig
from mcptam_tpu_torch.core.camera import CameraModel, unproject
from mcptam_tpu_torch.core.levels import level_zero_pos
from mcptam_tpu_torch.core.se3 import SE3
from mcptam_tpu_torch.map.builder import add_measurements, add_points, commit_mkf
from mcptam_tpu_torch.map.epipolar import create_epipolar_points
from mcptam_tpu_torch.map.keyframe import FrameFeatures
from mcptam_tpu_torch.map.refind import refind_in_keyframes
from mcptam_tpu_torch.map.state import (
    SRC_TRACKER, MapState, closest_kf, closest_mkf_distance, clone_tree,
    count_mkfs, kf_cam_from_world, refresh_scene_depths,
)


def _level_candidates(feats: FrameFeatures, cam: int, level: int, cap: int):
    """The `cap` strongest candidates (by FAST score) of a camera and level
    as (xy (cap,2) f32, want).  A stable descending sort keeps tied scores
    lowest index first, as jax.lax.top_k does."""
    score = torch.where(feats.cand_valid[level][cam], feats.cand_score[level][cam],
                        torch.full_like(feats.cand_score[level][cam], -1.0))
    vals, pos = torch.sort(score, descending=True, stable=True)
    vals, pos = vals[:cap], pos[:cap]
    return feats.cand_xy[level][cam][pos].to(torch.float32), vals > 0.0


def thin_candidates(ms: MapState, mkf_idx, cam, level, xy_level, want,
                    radius: float = 10.0):
    """Drop candidates within `radius` level px of an existing measurement
    of this keyframe at the same level or one above (ThinCandidates,
    src/MapMakerServerBase.cc:411-447).  cam/level are (Q,) tensors."""
    meas = ms.meas
    busy = (
        (meas.valid & (meas.mkf == mkf_idx))[None, :]
        & (meas.cam[None, :] == cam[:, None])
        & ((meas.level[None, :] == level[:, None])
           | (meas.level[None, :] == level[:, None] + 1))
    )                                                        # (Q,K)
    busy_xy = meas.uv_l0[None, :, :] / torch.exp2(level.to(torch.float32))[:, None, None]
    d2 = torch.sum((xy_level[:, None, :] - busy_xy) ** 2, -1)
    near = torch.any(busy & (d2 < radius * radius), -1)
    return want & ~near


def _epi_pass(ms, cams, mkf_idx, feats, levels, region: str, cam_active,
              mcfg: MapMakerConfig, cap_per_level: int):
    """One region pass of AddStereoMapPoints over the given levels.  For
    "other" the camera blocks of a level are stacked into one call (they
    never interact within a level); for "self" the target is a sibling
    camera of this MKF, so cameras run in order, each thinned against the
    measurements the previous ones created.  Returns (ms, n_created)."""
    C = ms.cam_from_base.t.shape[0]
    dev = ms.mkfs.valid.device
    made_total = torch.zeros((), dtype=torch.int64, device=dev)
    tgts = [closest_kf(ms, mkf_idx, c, region) for c in range(C)]
    kw = dict(n_hypotheses=mcfg.epi_max_hypotheses,
              corner_ambiguity=mcfg.epi_corner_ambiguity)
    for level in levels:
        blocks = []
        for c in range(C):
            xy, want = _level_candidates(feats, c, level, cap_per_level)
            Q = xy.shape[0]
            want = want & cam_active[c]
            tgt_m, tgt_c, tgt_ok = tgts[c]
            if region == "self":
                tgt_ok = tgt_ok & cam_active[tgt_c.long()]
            blocks.append((xy, want & tgt_ok,
                           torch.full((Q,), c, dtype=torch.int32, device=dev),
                           tgt_m.expand(Q), tgt_c.expand(Q)))
        if region == "self":
            groups = blocks
        else:
            groups = [tuple(torch.cat(parts) for parts in zip(*blocks))]
        for xy, want, camv, tmv, tcv in groups:
            QT = xy.shape[0]
            lvlv = torch.full((QT,), level, dtype=torch.int32, device=dev)
            want = thin_candidates(ms, mkf_idx, camv, lvlv, xy, want, mcfg.thin_radius)
            ms, made = create_epipolar_points(
                ms, cams, src_mkf=mkf_idx.expand(QT), src_cam=camv, tgt_mkf=tmv,
                tgt_cam=tcv, level=lvlv, xy_level=xy, want=want, **kw)
            made_total = made_total + torch.sum(made)
    return ms, made_total


def init_from_mkf(ms: MapState, cams: CameraModel, feats: FrameFeatures,
                  base_pose: SE3, mcfg: MapMakerConfig = DEFAULT_MAPMAKER,
                  cap_per_level: int = 64):
    """Bootstrap the map from the first MultiKeyFrame, which becomes the
    fixed gauge anchor.  With C > 1 cameras, the strongest candidates of
    camera c, coarse levels first, try an epipolar match in camera
    (c+1) % C of the same MKF, each camera thinned against the points the
    earlier ones made; with one camera they become points at
    ``mcfg.init_depth``.  Updates ms in place; returns (ms, mkf_idx)."""
    C = ms.cam_from_base.t.shape[0]
    dev = ms.mkfs.valid.device
    ms, mkf_idx, _ = commit_mkf(ms, feats, base_pose, fixed=True)
    kcw = kf_cam_from_world(ms)
    for level in range(LEVELS - 1, -1, -1):
        for c in range(C):
            xy, want = _level_candidates(feats, c, level, cap_per_level)
            Q = xy.shape[0]
            cam_arr = torch.full((Q,), c, dtype=torch.int32, device=dev)
            lvl_arr = torch.full((Q,), level, dtype=torch.int32, device=dev)
            if C > 1:
                want = thin_candidates(ms, mkf_idx, cam_arr, lvl_arr, xy, want,
                                       mcfg.thin_radius)
                ms, _ = create_epipolar_points(
                    ms, cams, src_mkf=mkf_idx.expand(Q), src_cam=cam_arr,
                    tgt_mkf=mkf_idx.expand(Q),
                    tgt_cam=torch.full((Q,), (c + 1) % C, dtype=torch.int32, device=dev),
                    level=lvl_arr, xy_level=xy, want=want,
                    n_hypotheses=mcfg.epi_max_hypotheses,
                    corner_ambiguity=mcfg.epi_corner_ambiguity)
            else:
                pose_c = SE3(R=kcw.R[mkf_idx, c], t=kcw.t[mkf_idx, c])
                rays = unproject(cams[c], level_zero_pos(xy, float(level)))
                pos_w = pose_c.inv().apply(rays * mcfg.init_depth)
                ms, _, _ = add_points(ms, cams, mkf_idx=mkf_idx, cam_idx=cam_arr,
                                      level=lvl_arr, xy_level=xy, pos_w=pos_w,
                                      want=want)
    return refresh_scene_depths(ms), mkf_idx


def record_tracker_measurements(ms: MapState, mkf_idx, result, enable=True):
    """The tracker's found positions as SRC_TRACKER measurements of the new
    MKF (Tracker::RecordMeasurements, src/Tracker.cc:1237-1274)."""
    want = result.sel_found & ~result.sel_outlier & enable
    K = want.shape[0]
    return add_measurements(
        ms, mkf=mkf_idx.expand(K), cam=result.sel_cam, point=result.sel_point,
        level=result.sel_level.to(torch.int32), uv_l0=result.sel_pos_l0, want=want,
        source=torch.full((K,), SRC_TRACKER, dtype=torch.int32, device=want.device),
        subpix=result.sel_subpix)


def integrate_mkf_device(ms: MapState, cams: CameraModel, feats: FrameFeatures,
                         base_pose: SE3, tracker_result=None,
                         mcfg: MapMakerConfig = DEFAULT_MAPMAKER,
                         cap_per_level: int = 32, cam_active=None):
    """Every pass of an integration, unconditionally, with no host sync.
    Updates ms in place; returns (ms, mkf_idx, n_large_points, slot_ok)."""
    C = ms.cam_from_base.t.shape[0]
    ms, mkf_idx, ok = commit_mkf(ms, feats, base_pose, kf_valid=cam_active)
    cam_active = (ok.expand(C) if cam_active is None else cam_active & ok)
    if tracker_result is not None:
        ms = record_tracker_measurements(ms, mkf_idx, tracker_result, enable=ok)

    # refind existing points in the new keyframes only
    target = torch.zeros(ms.mkfs.capacity, dtype=torch.bool, device=ok.device)
    target[mkf_idx] = ok
    ms, _ = refind_in_keyframes(ms, cams, target_mkf_mask=target)

    min_level = 0 if mcfg.level_zero_points else 1
    # KF_ONLY_OTHER, coarse levels first (ref :368-378): the sanity
    # quantity is the number of large (level >= 2) points this creates
    ms, n_large = _epi_pass(ms, cams, mkf_idx, feats, [3, 2], "other",
                            cam_active, mcfg, cap_per_level)
    ms, _ = _epi_pass(ms, cams, mkf_idx, feats, list(range(1, min_level - 1, -1)),
                      "other", cam_active, mcfg, cap_per_level)
    # KF_ONLY_SELF: cross-camera stereo inside this MKF (ref :383-391)
    if C > 1 and mcfg.cross_camera:
        ms, _ = _epi_pass(ms, cams, mkf_idx, feats,
                          list(range(LEVELS - 1, min_level - 1, -1)), "self",
                          cam_active, mcfg, cap_per_level)
    return refresh_scene_depths(ms), mkf_idx, n_large, ok


def integrate_mkf(ms: MapState, cams: CameraModel, feats: FrameFeatures,
                  base_pose: SE3, tracker_result=None,
                  mcfg: MapMakerConfig = DEFAULT_MAPMAKER,
                  cap_per_level: int = 32, cam_active=None):
    """Integrate on a copy, then accept or drop it: an MKF that fails the
    large-point sanity test (or finds the store full) leaves ``ms`` as it
    was.  Returns (ms, mkf_idx, accepted)."""
    ms_new, mkf_idx, n_large, slot_ok = integrate_mkf_device(
        clone_tree(ms), cams, feats, base_pose, tracker_result, mcfg,
        cap_per_level, cam_active)
    if not bool(slot_ok) or (mcfg.large_point_test and int(n_large) == 0):
        return ms, mkf_idx, False
    return ms_new, mkf_idx, True


def need_new_mkf(ms: MapState, pose: SE3, mean_depth,
                 mcfg: MapMakerConfig = DEFAULT_MAPMAKER, queue_dist=None):
    """MapMakerClientBase::NeedNewMultiKeyFrame (src/MapMakerClientBase.cc:
    111-152): depth-scaled distance to the closest MKF, in the map and,
    when ``queue_dist`` is given, in the map-maker queue, against
    sdMaxScaledMKFDist shrunk by 1 - 1/(0.5 + n_mkfs) (n=2 counts as 1).
    Returns (add, scaled distance)."""
    d, _ = closest_mkf_distance(ms, pose, mean_depth)
    if queue_dist is not None:
        d = torch.minimum(d, queue_dist)
    scaled = d / torch.clamp(mean_depth, min=1e-6)
    n = count_mkfs(ms)
    n_eff = torch.where(n == 2, torch.ones_like(n), n).to(torch.float32)
    thresh = mcfg.max_scaled_mkf_dist * (1.0 - 1.0 / (0.5 + n_eff))
    return scaled > thresh, scaled
