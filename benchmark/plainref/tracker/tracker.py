"""Multi-camera tracking front-end: per-frame pose estimation (port of
mcptam_tpu/tracker/tracker.py, ref src/Tracker.cc).

Per frame (ref TrackFrame, src/Tracker.cc:409-518):
  1. SBI ESM rotation (the ESM kernel on the card) + decayed
     constant-velocity motion model;
  2. PVS: every point projected into every camera, with its patch warp and
     search level;
  3. coarse stage: up to 60 level>=2 pairs searched at 30 px, then 10
     Gauss-Newton pose iterations;
  4. fine stage: up to 1000 pairs searched at 10/5 px with subpixel
     refinement;
  5. Tukey-reweighted 6-DOF pose solve with prior 100, covariance H^-1;
  6. per-camera quality, lost counter, motion-model update.

Every shape is static and nothing syncs with the host: data-dependent
choices are ``torch.where`` selections, as in the reference.

``track_frame`` takes an optional process group (parallel/mesh.py).  Each
rank then holds a block of the map's points (``shard_map_points``): it
projects its own points (the PVS), the valid masks are all-gathered so that
every rank selects the same pairs in the same global order, each pair is
searched against its point's rows on the rank that owns the point, and the
owners' results and the selected points' positions are gathered in
selection order.  Every rank then runs the pose solves and the finalize
step on the same inputs as the unsharded tracker, so its result is the
same, bit for bit.  With no group nothing is gathered.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace

import numpy as np
import torch

from plainref.config import SBI_SIZE, TrackerConfig, DEFAULT_TRACKER
from plainref.core import mest
from plainref.core.camera import (
    CameraModel, cam_sphere_deriv, project, projection_derivs_sphere,
)
from plainref.core.linalg import solve_spd
from plainref.core.se3 import SE3, geodesic_rotation_mean, so3_ln
from plainref.map.keyframe import FrameFeatures
from plainref.map.state import MapState, closest_mkf_distance
from plainref.ops import batch_patch as bp
from plainref.ops.atlas import _level0_width_from_atlas, level_size_arrays
from plainref.ops.patch import pack_corner_atlas, warp_and_search_level
from plainref.ops.sbi import se3_from_se2
from plainref.ops.sbi_kernel import esm_align_all
from plainref.parallel.collectives import from_owner, gather_cat, rank_world

QUALITY_GOOD = 0
QUALITY_DODGY = 1
QUALITY_BAD = 2


@dataclass
class TrackerState:
    pose: SE3                  # base_from_world
    vel: torch.Tensor          # (6,) motion-model velocity
    sbi_prev: torch.Tensor     # (C,ROWS,COLS) previous-frame SBI templates
    sbi_prev_gx: torch.Tensor
    sbi_prev_gy: torch.Tensor
    have_prev: torch.Tensor    # () bool
    lost_count: torch.Tensor   # () int32
    quality: torch.Tensor      # () int32 (QUALITY_*)


def create_tracker_state(n_cams: int, device="cuda") -> TrackerState:
    R, C = SBI_SIZE
    z = functools.partial(torch.zeros, device=device)
    return TrackerState(
        pose=SE3.identity(device=device), vel=z(6),
        sbi_prev=z((n_cams, R, C)), sbi_prev_gx=z((n_cams, R, C)),
        sbi_prev_gy=z((n_cams, R, C)), have_prev=z((), dtype=torch.bool),
        lost_count=z((), dtype=torch.int32),
        quality=torch.tensor(QUALITY_BAD, dtype=torch.int32, device=device),
    )


@dataclass
class TrackResult:
    pose: SE3
    cov: torch.Tensor            # (6,6)
    sel_point: torch.Tensor      # (K,) int32 selected fine-stage pairs
    sel_cam: torch.Tensor        # (K,) int32
    sel_level: torch.Tensor      # (K,)
    sel_pos_l0: torch.Tensor     # (K,2) found positions
    sel_found: torch.Tensor      # (K,)
    sel_outlier: torch.Tensor    # (K,) Tukey-zero in the final solve
    sel_subpix: torch.Tensor     # (K,)
    num_found: torch.Tensor      # (C,)
    num_attempted: torch.Tensor  # (C,)
    mean_depth: torch.Tensor     # (C,)
    depth_sigma: torch.Tensor    # (C,)
    quality: torch.Tensor        # () int32
    quality_per_cam: torch.Tensor  # (C,) int32
    lost: torch.Tensor           # () bool
    sbi_rot: torch.Tensor        # (3,)
    tot_found: torch.Tensor      # ()


# ---------------------------------------------------------------------------
# SBI rotation
# ---------------------------------------------------------------------------

def calc_sbi_rotation(ts: TrackerState, feats: FrameFeatures,
                      cams_sbi: CameraModel, cam_from_base: SE3,
                      cam_active):
    """Per-camera ESM prev->cur rotation averaged in the base frame (ref
    CalcSBIRotation, src/Tracker.cc:1687-1749).  Returns (w (3,), valid)."""
    se2, _ = esm_align_all(ts.sbi_prev, feats.sbi, feats.sbi_gx, feats.sbi_gy)
    # se3_from_se2 gives prev_from_cur; the motion model wants cur_from_prev
    R_cur_from_prev = se3_from_se2(se2, cams_sbi, cams_sbi).transpose(-1, -2)
    Rcb = cam_from_base.R
    Rs = Rcb.transpose(-1, -2) @ R_cur_from_prev @ Rcb
    mask = cam_active.to(torch.float32)
    R_mean = geodesic_rotation_mean(Rs, mask)
    have = ts.have_prev & (torch.sum(mask) > 0)
    return so3_ln(R_mean), have


# ---------------------------------------------------------------------------
# PVS and pair selection
# ---------------------------------------------------------------------------

def compute_pvs(ms: MapState, cams: CameraModel, pose_base: SE3):
    """Project all points into all cameras with per-pair warp + search
    level (ref FindPVS, src/Tracker.cc:663-723).  Returns (C,N) tensors."""
    pts = ms.points
    cfb = ms.cam_from_base
    p_base = pose_base.apply(pts.pos_w)                          # (N,3)
    p_cam = torch.einsum("cij,nj->cni", cfb.R, p_base) + cfb.t[:, None, :]
    cams_b = cams[:, None]
    uv, proj_ok = project(cams_b, p_cam)
    duv = projection_derivs_sphere(cams_b, p_cam)                # (C,N,2,2)
    d_th, d_ph = cam_sphere_deriv(p_cam)                         # (C,N,3)
    R_cw = cfb.R @ pose_base.R                                   # (C,3,3)
    warp, level, warp_ok = warp_and_search_level(
        duv, d_th, d_ph, R_cw[:, None], pts.pixel_right_w[None],
        pts.pixel_down_w[None],
    )
    live = pts.valid & ~pts.bad
    valid = proj_ok & warp_ok & live[None, :]
    return dict(uv=uv, p_cam=p_cam, p_base=p_base, duv=duv, d_th=d_th,
                d_ph=d_ph, warp=warp, level=level, valid=valid)


@functools.lru_cache(maxsize=16)
def _pair_perm(C: int, N: int, device) -> torch.Tensor:
    """Static permutation of the (C*N) pair grid in hash-priority order
    (the reference's random PVS shuffle), computed once in host numpy
    uint64 — descending priority, index as the stable tiebreak.  Cached
    per device; callers must not modify it."""
    n = np.arange(N, dtype=np.uint64)
    c = np.arange(C, dtype=np.uint64)[:, None]
    h = (n * 2654435761 + c * 40503) & 0xFFFF
    # the negation wraps in uint64 exactly as the reference's does
    perm = np.argsort(-h.reshape(-1), kind="stable")
    return torch.as_tensor(perm, device=device)


def _select_pairs(valid_cn, perm, k: int):
    """First k valid pairs in permutation order, by cumsum compaction into
    a k+1 buffer whose slot k is the sink for everything else."""
    v = valid_cn.reshape(-1)[perm]
    rank = torch.cumsum(v.to(torch.int64), 0) - 1
    tgt = torch.where(v & (rank < k), rank, torch.full_like(rank, k))
    idx = torch.zeros(k + 1, dtype=torch.int64, device=perm.device)
    idx = idx.scatter(0, tgt, perm)[:k]
    n_sel = torch.clamp(torch.sum(v.to(torch.int64)), max=k)
    return idx, torch.arange(k, device=perm.device) < n_sel


@dataclass
class _Pairs:
    """k selected (camera, point) pairs and where their points live: ``pt``
    is the point's index in the whole map, ``loc`` its row in this rank's
    shard (0 where another rank owns it), ``flat`` the pair's index in this
    rank's (C, N) PVS grid, ``owner`` the owning rank (None unsharded)."""
    cam: torch.Tensor
    pt: torch.Tensor
    ok: torch.Tensor
    loc: torch.Tensor
    flat: torch.Tensor
    owner: torch.Tensor = None
    group: object = None

    def grid(self, x: torch.Tensor) -> torch.Tensor:
        """Per-pair rows of a (C*N, ...) PVS array, from each pair's owner."""
        return from_owner(x[self.flat], self.owner, self.group)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """Per-pair rows of an (N, ...) point array, from each pair's owner."""
        return from_owner(x[self.loc], self.owner, self.group)

    def owned(self, x: torch.Tensor) -> torch.Tensor:
        """x, computed for every pair on every rank, taken from the owners."""
        return from_owner(x, self.owner, self.group)

    def mine(self, ok: torch.Tensor) -> torch.Tensor:
        """ok, and on a shard only where this rank holds the point."""
        if self.owner is None:
            return ok
        return ok & (self.owner == rank_world(self.group)[0])


def _select_global(valid_cn, k: int, group):
    """The first k valid pairs of the whole map's (C, N) grid in the
    global pair order, from this rank's (C, N_local) block of it."""
    C, N = valid_cn.shape
    rank, world = rank_world(group)
    Ng = N * world
    idx, ok = _select_pairs(gather_cat(valid_cn, group, 1),
                            _pair_perm(C, Ng, valid_cn.device), k)
    cam = torch.div(idx, Ng, rounding_mode="floor")
    pt = idx % Ng
    if group is None:
        return _Pairs(cam=cam, pt=pt, ok=ok, loc=pt, flat=idx)
    owner = torch.div(pt, N, rounding_mode="floor")
    loc = torch.where(owner == rank, pt - rank * N, torch.zeros_like(pt))
    return _Pairs(cam=cam, pt=pt, ok=ok, loc=loc, flat=cam * N + loc,
                  owner=owner, group=group)


# ---------------------------------------------------------------------------
# Search over selected pairs
# ---------------------------------------------------------------------------

def search_pairs(ms: MapState, feats: FrameFeatures, cam_idx, pt_idx,
                 uv_pred, warp, level, sel_ok, range_l0: int, max_range,
                 subpix_its: int, max_ssd: float):
    """Template + ZMSSD search + subpixel for K selected (cam, point) pairs.
    Invalid pairs come out found=False."""
    pts = ms.points
    packed = pack_corner_atlas(feats.atlas, feats.corner_atlas)
    H = feats.atlas.shape[1]
    W0 = _level0_width_from_atlas(feats.atlas.shape[2])
    level_hw = level_size_arrays(H, W0, packed.device)

    tmpl, t_ok = bp.make_warped_templates(
        pts.src_window[pt_idx], pts.src_window_ok[pt_idx], level_hw,
        pts.src_level[pt_idx].long(), pts.center_xy[pt_idx], warp, level,
    )
    # fixed points (calibration grid) are searched at every offset, not only
    # at FAST corners (ref src/Tracker.cc:1323-1334)
    found, pos, _, aux = bp.find_patches(
        packed, level_hw, cam_idx, level, tmpl, uv_pred, range_l0,
        max_range, exhaustive=pts.fixed[pt_idx], max_ssd=max_ssd,
    )
    found = found & t_ok & sel_ok
    pos_ref, conv = bp.subpix_refine_region(aux, level_hw, level, tmpl, pos,
                                            subpix_its)
    pos = torch.where((conv & found)[:, None], pos_ref, pos)
    return found, pos, conv & found


# ---------------------------------------------------------------------------
# Pose solve
# ---------------------------------------------------------------------------

def _pair_project(cams, cfb: SE3, pose: SE3, pos_w, cam_idx):
    """Projection only, for K (point, camera) pairs."""
    p_base = pose.apply(pos_w)
    p_cam = torch.einsum("kij,kj->ki", cfb.R[cam_idx], p_base) + cfb.t[cam_idx]
    return project(cams[cam_idx], p_cam)


def _pair_jacobian(cams, cfb: SE3, pose: SE3, pos_w, cam_idx):
    """Projection + 2x6 base-pose Jacobian for K pairs (ref
    TrackerData::CalcJacobian, include/mcptam/TrackerData.h:152-178).
    Returns (uv (K,2), proj_ok (K,), J (K,2,6), p_cam (K,3))."""
    p_base = pose.apply(pos_w)
    Rcb = cfb.R[cam_idx]
    p_cam = torch.einsum("kij,kj->ki", Rcb, p_base) + cfb.t[cam_idx]
    cams_k = cams[cam_idx]
    uv, proj_ok = project(cams_k, p_cam)
    duv = projection_derivs_sphere(cams_k, p_cam)                # (K,2,2)
    d_th, d_ph = cam_sphere_deriv(p_cam)                         # (K,3)
    # generator fields: translation e_j, then rotation e_j x p_base
    K = p_base.shape[0]
    eye = torch.eye(3, device=p_base.device).expand(K, 3, 3)
    zero = torch.zeros_like(p_base[:, 0])
    px, py, pz = p_base[:, 0], p_base[:, 1], p_base[:, 2]
    rot_gens = torch.stack([
        torch.stack([zero, -pz, py], -1),
        torch.stack([pz, zero, -px], -1),
        torch.stack([-py, px, zero], -1),
    ], 1)
    gens = torch.cat([eye, rot_gens], 1)                         # (K,6,3)
    dcam = torch.einsum("kij,kgj->kgi", Rcb, gens)               # (K,6,3)
    sph = torch.stack([
        torch.einsum("kd,kgd->kg", d_th, dcam),
        torch.einsum("kd,kgd->kg", d_ph, dcam),
    ], 1)                                                        # (K,2,6)
    return uv, proj_ok, duv @ sph, p_cam


def pose_solve(pose: SE3, ms: MapState, cams, cam_idx, pt_idx, found,
               found_pos, level, iterations: int, prior: float,
               sigma_floor: float, pos_w=None):
    """Iterated Tukey-weighted 6-DOF WLS (ref CalcPoseUpdate,
    src/Tracker.cc:1386-1511) on the reference's schedule: full
    re-projection + Jacobians at iterations 0, 4 and the last, linear
    residual updates (e -= J delta) in between; the MAD sigma is
    recomputed at each re-linearisation.  pos_w: the pairs' (K,3) point
    positions, when not ``ms.points.pos_w[pt_idx]`` (a sharded map).

    Returns (pose, H (6,6), final weights (K,), final residuals (K,2))."""
    if pos_w is None:
        pos_w = ms.points.pos_w[pt_idx]
    cfb = ms.cam_from_base
    inv_scale = 1.0 / torch.exp2(level.to(torch.float32))
    eye6 = torch.eye(6, device=pos_w.device)

    def full_linearize(pose):
        uv, proj_ok, J, _ = _pair_jacobian(cams, cfb, pose, pos_w, cam_idx)
        mask = found & proj_ok
        e = (found_pos - uv) * inv_scale[:, None]
        Js = J * inv_scale[:, None, None]
        # masked pairs may carry non-finite values; zero them explicitly
        fin = (mask & torch.isfinite(Js).all(-1).all(-1)
               & torch.isfinite(e).all(-1))
        Js = torch.where(fin[:, None, None], Js, torch.zeros_like(Js))
        e = torch.where(fin[:, None], e, torch.zeros_like(e))
        return Js, e, fin

    relinearize_at = {0, 4, max(0, iterations - 1)}
    H = eye6
    w = torch.zeros(found.shape, device=pos_w.device)
    for i in range(iterations):
        if i in relinearize_at:
            Js, e, mask = full_linearize(pose)
            err_sq = torch.sum(e * e, -1)
            sigma_sq = torch.clamp(mest.find_sigma_squared(err_sq, mask),
                                   min=sigma_floor)
        err_sq = torch.sum(e * e, -1)
        w = mest.weight(mest.TUKEY, err_sq, sigma_sq) * mask
        Jw = Js * w[:, None, None]
        H = torch.einsum("kiv,kiw->vw", Jw, Js) + prior * eye6
        b = torch.einsum("kiv,ki->v", Jw, e)
        delta = solve_spd(H, b)
        pose = SE3.exp(delta) @ pose
        e = e - torch.einsum("kiv,v->ki", Js, delta)  # linear residual update

    uv, _, _, _ = _pair_jacobian(cams, cfb, pose, pos_w, cam_idx)
    return pose, H, w, (found_pos - uv) * inv_scale[:, None]


def robust_mean_depth(p_cam_z, mask):
    """Huber-robust mean depth along the last axis (ref RefreshSceneDepth
    via the tracker, src/Tracker.cc:1180-1228)."""
    med = mest.masked_median_bisect(p_cam_z, mask)
    d_sq = (p_cam_z - med[..., None]) ** 2
    sig = torch.clamp(mest.find_sigma_squared(d_sq, mask), min=0.4)
    w = torch.sqrt(mest.weight(mest.HUBER, d_sq, sig[..., None])) * mask
    sw = torch.clamp(torch.sum(w, -1), min=1e-9)
    mean = torch.sum(w * p_cam_z, -1) / sw
    var = torch.sum(w * p_cam_z * p_cam_z, -1) / sw - mean * mean
    return mean, torch.sqrt(torch.clamp(var, min=1e-12))


# ---------------------------------------------------------------------------
# The frame step
# ---------------------------------------------------------------------------

def _stage_sbi(ts: TrackerState, feats: FrameFeatures, cams_sbi: CameraModel,
               cam_from_base: SE3, tcfg: TrackerConfig, cam_active):
    """Stage 1a: SBI ESM rotation estimate."""
    if tcfg.use_sbi_rotation:
        return calc_sbi_rotation(ts, feats, cams_sbi, cam_from_base, cam_active)
    dev = ts.vel.device
    return torch.zeros(3, device=dev), torch.zeros((), dtype=torch.bool, device=dev)


def _stage_motion(ts: TrackerState, sbi_rot, have_rot) -> SE3:
    """Stage 1b: decayed constant velocity with the rotation replaced by
    the SBI estimate (ApplyMotionModel, src/Tracker.cc:1516-1536)."""
    v6 = torch.where(have_rot, torch.cat([ts.vel[:3], sbi_rot]), ts.vel)
    return SE3.exp(v6) @ ts.pose


def _stage_pvs(ms: MapState, cams: CameraModel, pose_pred: SE3, cam_active):
    """Stage 2: potentially-visible set over the (camera x point) grid (of
    this rank's points, on a shard)."""
    pvs = compute_pvs(ms, cams, pose_pred)
    pvs["valid"] = pvs["valid"] & cam_active[:, None]
    return pvs


def _stage_coarse(ms: MapState, cams: CameraModel, feats: FrameFeatures, pvs,
                  pose_pred: SE3, tcfg: TrackerConfig, group=None):
    """Stage 3: level>=2 pairs searched at the coarse range + coarse GN
    solve (TestForCoarse, src/Tracker.cc:726-772).
    Returns (pose_after_coarse, do_coarse)."""
    dev = feats.atlas.device
    coarse_valid = pvs["valid"] & (pvs["level"] >= 2)
    c = _select_global(coarse_valid, tcfg.coarse_max, group)
    c_uv = c.grid(pvs["uv"].reshape(-1, 2))
    c_warp = c.grid(pvs["warp"].reshape(-1, 2, 2))
    c_lvl = c.grid(pvs["level"].reshape(-1))
    # coarse pairs are all level >= 2: the level-pixel radius is range/4
    coarse_range_lvl = -(-tcfg.coarse_range // 4)
    cf_found, cf_pos, _ = search_pairs(
        ms, feats, c.cam, c.loc, c_uv, c_warp, c_lvl, c.mine(c.ok), coarse_range_lvl,
        torch.full((), float(tcfg.coarse_range), device=dev),
        tcfg.coarse_sub_pix_its, max_ssd=64 * tcfg.max_ssd_per_pixel,
    )
    cf_found, cf_pos = c.owned(cf_found), c.owned(cf_pos)
    do_coarse = torch.sum(cf_found) >= tcfg.coarse_min
    pose_c, _, _, _ = pose_solve(
        pose_pred, ms, cams, c.cam, c.pt, cf_found, cf_pos, c_lvl,
        tcfg.coarse_iterations, tcfg.tracking_prior, tcfg.mest_sigma_min,
        pos_w=c.rows(ms.points.pos_w),
    )
    pose_after_coarse = SE3(R=torch.where(do_coarse, pose_c.R, pose_pred.R),
                            t=torch.where(do_coarse, pose_c.t, pose_pred.t))
    return pose_after_coarse, do_coarse


def _stage_fine(ms: MapState, cams: CameraModel, feats: FrameFeatures, pvs,
                pose_after_coarse: SE3, do_coarse, tcfg: TrackerConfig, group=None):
    """Stage 4: up to max_patches_per_frame pairs searched at 10/5 px +
    subpixel (src/Tracker.cc:841-905).  The PVS comes from the predicted
    pose; only the selected pairs' positions are re-projected under the
    coarse-refined pose."""
    dev = feats.atlas.device
    f = _select_global(pvs["valid"], tcfg.max_patches_per_frame, group)
    f_warp = f.grid(pvs["warp"].reshape(-1, 2, 2))
    f_lvl = f.grid(pvs["level"].reshape(-1))
    f_pos_w = f.rows(ms.points.pos_w)
    f_uv, f_proj_ok = _pair_project(cams, ms.cam_from_base, pose_after_coarse,
                                    f_pos_w, f.cam)
    f_ok = f.ok & f_proj_ok
    fine_range = torch.where(
        do_coarse, torch.full((), float(tcfg.fine_range), device=dev),
        torch.full((), float(tcfg.fine_range_first), device=dev))
    ff_found, ff_pos, ff_sub = search_pairs(
        ms, feats, f.cam, f.loc, f_uv, f_warp, f_lvl, f.mine(f_ok),
        tcfg.fine_range_first, fine_range, tcfg.fine_sub_pix_its,
        max_ssd=64 * tcfg.max_ssd_per_pixel,
    )
    return {"cam": f.cam, "pt": f.pt, "lvl": f_lvl, "ok": f_ok, "pos_w": f_pos_w,
            "found": f.owned(ff_found), "pos": f.owned(ff_pos), "sub": f.owned(ff_sub)}


def _stage_pose(ms: MapState, cams: CameraModel, pose_after_coarse: SE3,
                fine, tcfg: TrackerConfig):
    """Stage 5: Tukey-reweighted pose solve + covariance."""
    pose_new, H, w_final, _ = pose_solve(
        pose_after_coarse, ms, cams, fine["cam"], fine["pt"], fine["found"],
        fine["pos"], fine["lvl"], tcfg.fine_iterations, tcfg.tracking_prior,
        tcfg.mest_sigma_min, pos_w=fine["pos_w"],
    )
    # numpy's default pinv cutoff, as the reference's jnp.linalg.pinv
    cov = torch.linalg.pinv(H, rtol=10 * 6 * torch.finfo(H.dtype).eps)
    return pose_new, cov, fine["found"] & (w_final <= 0.0)


def track_frame(ts: TrackerState, ms: MapState, cams: CameraModel,
                cams_sbi: CameraModel, feats: FrameFeatures,
                tcfg: TrackerConfig = DEFAULT_TRACKER, cam_active=None,
                group=None):
    """One tracking step.  Returns (new TrackerState, TrackResult).

    cam_active: optional (C,) bool; absent cameras contribute no
    measurements and no rotation vote and keep their previous SBI.
    group: the ranks over which ``ms``'s points are sharded
    (parallel/mesh.py ``shard_map_points``); ``ms`` is then this rank's
    shard, and the result, with point indices into the whole map, is the
    same on every rank."""
    C = feats.atlas.shape[0]
    if cam_active is None:
        cam_active = torch.ones(C, dtype=torch.bool, device=feats.atlas.device)
    sbi_rot, have_rot = _stage_sbi(ts, feats, cams_sbi, ms.cam_from_base,
                                   tcfg, cam_active)
    pose_pred = _stage_motion(ts, sbi_rot, have_rot)
    pvs = _stage_pvs(ms, cams, pose_pred, cam_active)
    pose_after_coarse, do_coarse = _stage_coarse(ms, cams, feats, pvs,
                                                 pose_pred, tcfg, group)
    fine = _stage_fine(ms, cams, feats, pvs, pose_after_coarse, do_coarse, tcfg,
                       group)
    pose_new, cov, outlier = _stage_pose(ms, cams, pose_after_coarse, fine, tcfg)
    return _stage_finalize(ts, ms, feats, pose_new, cov, fine, outlier,
                           sbi_rot, tcfg, cam_active)


def _stage_finalize(ts: TrackerState, ms: MapState, feats: FrameFeatures,
                    pose_new: SE3, cov, fine, outlier, sbi_rot,
                    tcfg: TrackerConfig, cam_active):
    """Stage 6: per-camera robust scene depth, quality grading, lost
    counter, motion-model update (src/Tracker.cc:1076-1151, :1576-1658)."""
    C = feats.atlas.shape[0]
    dev = feats.atlas.device
    f_cam, f_pt, f_lvl, f_ok = fine["cam"], fine["pt"], fine["lvl"], fine["ok"]
    ff_found, ff_pos, ff_sub = fine["found"], fine["pos"], fine["sub"]

    # scene depth per camera from the found fine points
    cfb = ms.cam_from_base
    p_base = pose_new.apply(fine["pos_w"])
    p_cam = torch.einsum("kij,kj->ki", cfb.R[f_cam], p_base) + cfb.t[f_cam]
    depth = torch.linalg.vector_norm(p_cam, dim=-1)
    cam_onehot = f_cam[None, :] == torch.arange(C, device=dev)[:, None]  # (C,K)
    depth_mask = cam_onehot & ff_found[None, :]
    mean_depth, depth_sigma = robust_mean_depth(
        depth[None, :].expand(depth_mask.shape), depth_mask)

    # quality (ref AssessTrackingQuality, src/Tracker.cc:1613-1658); counts
    # of 0/1 are exact whatever order the index_add runs in
    f_okf = f_ok.to(torch.float32)
    ff_foundf = ff_found.to(torch.float32)
    large = (f_lvl >= 2).to(torch.float32)

    def per_cam(v):
        return torch.zeros(C, device=dev).index_add_(0, f_cam, v)

    attempted = per_cam(f_okf)
    found_per_cam = per_cam(ff_foundf)
    large_att = per_cam(f_okf * large)
    large_found = per_cam(ff_foundf * large)
    total_frac = found_per_cam / torch.clamp(attempted, min=1.0)
    large_frac = torch.where(large_att > tcfg.coarse_min,
                             large_found / torch.clamp(large_att, min=1.0),
                             total_frac)
    good = torch.full((C,), QUALITY_GOOD, dtype=torch.int32, device=dev)
    q_cam = torch.where(
        total_frac > tcfg.quality_good, good,
        torch.where(large_frac < tcfg.quality_bad, good + QUALITY_BAD,
                    good + QUALITY_DODGY))
    q_cam = torch.where(found_per_cam < tcfg.min_patches_per_frame,
                        good + QUALITY_BAD, q_cam)
    quality = torch.amin(q_cam)  # overall = best camera
    # DODGY demotes to BAD when the pose ran too far from the nearest MKF
    # (src/Tracker.cc:1589-1596, src/MapMakerClientBase.cc:203-211)
    has_depth = (found_per_cam > 0).to(torch.float32)
    cur_depth = torch.sum(mean_depth * has_depth) / torch.clamp(
        torch.sum(has_depth), min=1.0)
    d_near, ci = closest_mkf_distance(ms, pose_new, cur_depth)
    kfv = ms.mkfs.kf_valid[ci]
    closest_depth = torch.sum(torch.where(
        kfv, ms.mkfs.scene_depth_mean[ci], torch.zeros_like(ms.mkfs.scene_depth_mean[ci]))
    ) / torch.clamp(torch.sum(kfv.to(torch.float32)), min=1.0)
    excessive = d_near / torch.clamp(closest_depth, min=1e-6) > tcfg.excessive_mkf_dist
    quality = torch.where((quality == QUALITY_DODGY) & excessive,
                          torch.full_like(quality, QUALITY_BAD), quality)
    # lost counter: +1 on BAD (clamped), -1 on GOOD (clamped at 0)
    lost_count = torch.where(
        quality == QUALITY_BAD,
        torch.clamp(ts.lost_count + 1, max=tcfg.lost_frame_thresh),
        torch.where(quality == QUALITY_GOOD,
                    torch.clamp(ts.lost_count - 1, min=0), ts.lost_count),
    ).to(torch.int32)
    lost = lost_count >= tcfg.lost_frame_thresh

    # motion model update (ref UpdateMotionModel)
    new_vel = 0.9 * (pose_new @ ts.pose.inv()).ln()
    new_vel = torch.where(lost, torch.zeros_like(new_vel), new_vel)

    keep = cam_active[:, None, None]
    ts_new = replace(
        ts, pose=pose_new, vel=new_vel,
        sbi_prev=torch.where(keep, feats.sbi, ts.sbi_prev),
        sbi_prev_gx=torch.where(keep, feats.sbi_gx, ts.sbi_prev_gx),
        sbi_prev_gy=torch.where(keep, feats.sbi_gy, ts.sbi_prev_gy),
        have_prev=torch.ones((), dtype=torch.bool, device=dev),
        lost_count=lost_count, quality=quality.to(torch.int32),
    )
    result = TrackResult(
        pose=pose_new, cov=cov,
        sel_point=f_pt.to(torch.int32), sel_cam=f_cam.to(torch.int32),
        sel_level=f_lvl.to(torch.int32), sel_pos_l0=ff_pos,
        sel_found=ff_found, sel_outlier=outlier, sel_subpix=ff_sub,
        num_found=found_per_cam, num_attempted=attempted,
        mean_depth=mean_depth, depth_sigma=depth_sigma,
        quality=quality.to(torch.int32), quality_per_cam=q_cam,
        lost=lost, sbi_rot=sbi_rot, tot_found=torch.sum(ff_found),
    )
    return ts_new, result


def apply_tracker_point_stats(ms: MapState, result: TrackResult,
                              min_outliers: int = 20,
                              outlier_multiplier: float = 1.0,
                              enable=True, group=None) -> MapState:
    """Fold the tracker's in/outlier tallies into the map and flag bad
    points (ref MapMakerClientBase::MarkOutliers,
    src/MapMakerClientBase.cc:73-94).  enable=False (a bool tensor) makes
    it a no-op.  Updates the point arrays in place.  group: ``ms`` is this
    rank's shard of a map sharded by points (``track_frame``'s group); a
    rank writes the tallies of its own points."""
    pts = ms.points
    sel = result.sel_point.long()
    if group is not None:
        N = pts.capacity
        lo = rank_world(group)[0] * N
        mine = (sel >= lo) & (sel < lo + N)
        sel = torch.where(mine, sel - lo, torch.zeros_like(sel))
        enable = mine & enable
    inl = result.sel_found & ~result.sel_outlier & enable
    pts.in_count.index_add_(0, sel, inl.to(torch.int32))
    pts.out_count.index_add_(0, sel, (result.sel_outlier & enable).to(torch.int32))
    pts.bad |= (
        (pts.out_count > min_outliers)
        & (pts.out_count.to(torch.float32)
           > outlier_multiplier * pts.in_count.to(torch.float32))
        & pts.valid & ~pts.fixed
    )
    return ms
