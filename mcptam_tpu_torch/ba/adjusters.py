"""Bundle-adjuster variants: problems from the map, and the writeback
(port of mcptam_tpu/ba/adjusters.py, ref src/BundleAdjuster{Base,Multi,
Single,Calib}.cc).

  * ``problem_all``: global BA, every valid MKF movable but the first,
    every point with >= 2 measurements (BundleAdjustAll);
  * ``problem_recent``: local BA, the newest MKF and its recent_num
    closest neighbours, scoped to their points (BundleAdjustRecent);
  * ``problem_single``: every MKF base an independent movable pose, the
    first not pinned (BundleAdjusterSingle, the pose calibration's);
  * ``problem_calib``: shared movable extrinsics, camera 0 fixed
    (BundleAdjusterCalib);
  * ``compact_problem``: the live points and measurements gathered into
    smaller bucketed capacities;
  * ``writeback`` and ``apply_outliers`` (AdjustAndUpdate,
    HandleOutliers, src/MapMakerServerBase.cc:1198-1247).

Intended divergence from the reference: its ``compact_problem`` builds the
old-id -> new-slot lookup by scattering over every compacted slot, and the
empty slots (all pointing at point 0) overwrite point 0's entry, so point
0 is frozen in every compaction that is not full; its ``writeback``
scatters through the same duplicated index.  Here only occupied slots are
written, in both places.
"""

from __future__ import annotations

import torch

from mcptam_tpu_torch.ba.bundle import BundleProblem, LMState
from mcptam_tpu_torch.core.se3 import SE3
from mcptam_tpu_torch.map.state import (
    SRC_EPIPOLAR, SRC_ROOT, SRC_TRACKER, MapState, mkf_distance,
    refresh_pixel_vectors, refresh_scene_depths,
)

# static capacities of the compacted local problem
LOCAL_POINTS = 1024
LOCAL_MEAS = 8192


def _scatter_any(n: int, index, mask) -> torch.Tensor:
    """(n,) bool: out[i] = any(mask[index == i]) (``.at[].max`` on bools)."""
    out = torch.zeros(n, dtype=torch.int32, device=mask.device)
    return out.scatter_reduce(0, index.long(), mask.to(torch.int32),
                              reduce="amax") > 0


def _meas_counts_per_point(ms: MapState):
    L = ms.points.capacity
    ok = ms.meas.valid & ms.points.valid[ms.meas.point.long()]
    counts = torch.zeros(L, dtype=torch.int32, device=ok.device)
    return counts.index_add_(0, ms.meas.point.long(), ok.to(torch.int32))


def _base_problem(ms: MapState, movable_a, movable_b, movable_pt):
    pt = ms.meas.point.long()
    return BundleProblem(
        pose_a=ms.mkfs.base_from_world, pose_b=ms.cam_from_base,
        movable_a=movable_a, movable_b=movable_b,
        points=ms.points.pos_w, movable_pt=movable_pt,
        m_pose_a=ms.meas.mkf, m_pose_b=ms.meas.cam, m_point=ms.meas.point,
        m_cam=ms.meas.cam, m_uv=ms.meas.uv_l0, m_level=ms.meas.level,
        m_valid=(ms.meas.valid & ms.points.valid[pt] & ~ms.points.bad[pt]
                 & ms.mkfs.valid[ms.meas.mkf.long()]),
        pt_src_a=ms.points.src_mkf, pt_src_b=ms.points.src_cam,
    )


def _first_valid(valid: torch.Tensor):
    return torch.argmax(valid.to(torch.int32))   # first maximum, as jnp.argmax


def problem_all(ms: MapState) -> BundleProblem:
    """Global BA: all valid MKFs movable except the first (and any fixed);
    points need >= 2 measurements."""
    movable_a = ms.mkfs.valid & ~ms.mkfs.fixed
    movable_a[_first_valid(ms.mkfs.valid)] = False
    C = ms.cam_from_base.t.shape[0]
    movable_b = torch.zeros(C, dtype=torch.bool, device=movable_a.device)
    pts = ms.points
    movable_pt = (pts.valid & ~pts.bad & ~pts.fixed
                  & (_meas_counts_per_point(ms) >= 2))
    return _base_problem(ms, movable_a, movable_b, movable_pt)


def problem_recent(ms: MapState, recent_num: int = 3) -> BundleProblem:
    """Local BA around the newest MKF: it and the recent_num closest valid
    MKFs are movable; other MKFs observing their points enter fixed.
    Measurements of points no movable MKF observes are masked out."""
    mk = ms.mkfs
    dev = mk.valid.device
    M = mk.capacity
    newest = torch.argmax(torch.where(mk.valid, mk.seq, torch.full_like(mk.seq, -1)))
    depth_n = torch.mean(mk.scene_depth_mean[newest])
    d = mkf_distance(ms, mk.base_from_world[newest], depth_n,
                     torch.arange(M, device=dev))
    inf = torch.full_like(d, float("inf"))
    d = torch.where(mk.valid & ~mk.fixed, d, inf)
    d[newest] = float("inf")
    first = _first_valid(mk.valid)
    d[first] = float("inf")            # the first MKF stays fixed (gauge)
    order = torch.argsort(d, stable=True)
    movable_a = torch.zeros(M, dtype=torch.bool, device=dev)
    movable_a[newest] = True
    movable_a[order[:recent_num]] = torch.isfinite(torch.sort(d).values)[:recent_num]
    movable_a = movable_a & mk.valid & ~mk.fixed
    movable_a[first] = False

    C = ms.cam_from_base.t.shape[0]
    movable_b = torch.zeros(C, dtype=torch.bool, device=dev)
    pts = ms.points
    touched = _scatter_any(pts.capacity, ms.meas.point,
                           ms.meas.valid & movable_a[ms.meas.mkf.long()])
    local_pt = pts.valid & ~pts.bad & (_meas_counts_per_point(ms) >= 2) & touched
    prob = _base_problem(ms, movable_a, movable_b, local_pt & ~pts.fixed)
    return prob.replace(m_valid=prob.m_valid & local_pt[ms.meas.point.long()])


def compact_problem(prob: BundleProblem, max_points: int = LOCAL_POINTS,
                    max_meas: int = LOCAL_MEAS) -> BundleProblem:
    """Gather the points referenced by a valid measurement, and the valid
    measurements of kept points, into smaller static capacities (cumsum
    compaction).  Poses keep their index space; ``pt_index`` / ``m_index``
    map back into the original arrays.  Entries beyond capacity drop."""
    L = prob.points.shape[0]
    K = prob.m_valid.shape[0]
    dev = prob.m_valid.device
    i32 = torch.int32
    pt_used = _scatter_any(L, prob.m_point, prob.m_valid)
    prank = torch.cumsum(pt_used.to(i32), 0) - 1
    pslot = torch.where(pt_used & (prank < max_points), prank,
                        torch.full_like(prank, max_points)).long()
    pt_index = torch.zeros(max_points + 1, dtype=i32, device=dev)
    pt_index[pslot] = torch.arange(L, dtype=i32, device=dev)   # dump slot last
    pt_index = pt_index[:max_points]
    n_pt = torch.clamp(torch.sum(pt_used.to(i32)), max=max_points)
    ar_p = torch.arange(max_points, device=dev)
    pt_ok = ar_p < n_pt
    # old id -> new slot, written from occupied slots only (the reference
    # also writes the empty ones, which all point at point 0)
    lut = torch.zeros(L + 1, dtype=i32, device=dev)
    lut[torch.where(pt_ok, pt_index.long(), L)] = ar_p.to(i32)
    lut = lut[:L]
    kept_pt = pt_used & (prank < max_points)

    m_ok = prob.m_valid & kept_pt[prob.m_point.long()]
    mrank = torch.cumsum(m_ok.to(i32), 0) - 1
    mslot = torch.where(m_ok & (mrank < max_meas), mrank,
                        torch.full_like(mrank, max_meas)).long()
    m_index = torch.zeros(max_meas + 1, dtype=i32, device=dev)
    m_index[mslot] = torch.arange(K, dtype=i32, device=dev)
    m_index = m_index[:max_meas]
    n_m = torch.clamp(torch.sum(m_ok.to(i32)), max=max_meas)
    m_keep = torch.arange(max_meas, device=dev) < n_m

    pi, mi = pt_index.long(), m_index.long()
    return prob.replace(
        points=prob.points[pi],
        movable_pt=prob.movable_pt[pi] & pt_ok,
        m_pose_a=prob.m_pose_a[mi], m_pose_b=prob.m_pose_b[mi],
        m_point=lut[prob.m_point[mi].long()], m_cam=prob.m_cam[mi],
        m_uv=prob.m_uv[mi], m_level=prob.m_level[mi],
        m_valid=prob.m_valid[mi] & m_keep,
        pt_src_a=None if prob.pt_src_a is None else prob.pt_src_a[pi],
        pt_src_b=None if prob.pt_src_b is None else prob.pt_src_b[pi],
        pt_index=pt_index, pt_index_ok=pt_ok, m_index=m_index, m_index_ok=m_keep,
    )


def problem_live_counts(prob: BundleProblem):
    """(points referenced by a valid measurement, valid measurements):
    device scalars the scheduler fetches to pick compaction buckets."""
    L = prob.points.shape[0]
    pt_used = _scatter_any(L, prob.m_point, prob.m_valid)
    return (torch.sum(pt_used.to(torch.int32)),
            torch.sum(prob.m_valid.to(torch.int32)))


def expand_outliers(prob: BundleProblem, outlier_mask, full_K: int):
    """A (possibly compacted) problem's outlier mask on the full
    measurement array."""
    if prob.m_index is None:
        return outlier_mask
    return _scatter_any(full_K, prob.m_index, outlier_mask & prob.m_index_ok)


def problem_single(ms: MapState) -> BundleProblem:
    """Independent-pose BA (BundleAdjusterSingle,
    src/BundleAdjusterSingle.cc:55-120): every valid, non-fixed MKF base
    moves freely.  The pose-calibration map holds one single-camera MKF per
    dropped keyframe with identity extrinsics, so each base IS an
    independent camera-from-world pose.  Unlike problem_all the first MKF
    is not pinned: the board-anchored FIXED points carry the gauge (the
    reference clears mbFixed on the init MKF, src/MapMakerCalib.cc:72-80)."""
    movable_a = ms.mkfs.valid & ~ms.mkfs.fixed
    C = ms.cam_from_base.t.shape[0]
    movable_b = torch.zeros(C, dtype=torch.bool, device=movable_a.device)
    pts = ms.points
    movable_pt = (pts.valid & ~pts.bad & ~pts.fixed
                  & (_meas_counts_per_point(ms) >= 2))
    return _base_problem(ms, movable_a, movable_b, movable_pt)


def problem_calib(ms: MapState) -> BundleProblem:
    """Extrinsic-calibration BA (BundleAdjusterCalib,
    src/BundleAdjusterCalib.cc:88-308): the shared cam-from-base poses
    movable but camera 0's (the reference), MKF bases movable but the
    first; points need one measurement."""
    movable_a = ms.mkfs.valid & ~ms.mkfs.fixed
    movable_a[_first_valid(ms.mkfs.valid)] = False
    C = ms.cam_from_base.t.shape[0]
    movable_b = torch.ones(C, dtype=torch.bool, device=movable_a.device)
    movable_b[0] = False
    pts = ms.points
    movable_pt = (pts.valid & ~pts.bad & ~pts.fixed
                  & (_meas_counts_per_point(ms) >= 1))
    return _base_problem(ms, movable_a, movable_b, movable_pt)


def writeback(ms: MapState, prob: BundleProblem, st: LMState) -> MapState:
    """Movable MKF poses, extrinsics and points into the map, optimized
    flags set, then pixel vectors and scene depths refreshed
    (AdjustAndUpdate, src/BundleAdjusterMulti.cc:267-337).  Updates ms."""
    mvA = prob.movable_a
    base = ms.mkfs.base_from_world
    ms.mkfs.base_from_world = SE3(
        R=torch.where(mvA[:, None, None], st.pose_a.R, base.R),
        t=torch.where(mvA[:, None], st.pose_a.t, base.t))
    mvB = prob.movable_b
    cfb = ms.cam_from_base
    ms.cam_from_base = SE3(R=torch.where(mvB[:, None, None], st.pose_b.R, cfb.R),
                           t=torch.where(mvB[:, None], st.pose_b.t, cfb.t))
    pts = ms.points
    mvL = prob.movable_pt
    if prob.pt_index is not None:
        # compacted: scatter the occupied, movable slots back
        N = pts.capacity
        mv = mvL & prob.pt_index_ok
        dst = torch.where(mv, prob.pt_index.long(), N)
        pos = torch.cat([pts.pos_w, pts.pos_w[:1]])
        pos[dst] = st.points
        pts.pos_w = pos[:N]
        pts.optimized = pts.optimized | _scatter_any(N, prob.pt_index, mv)
    else:
        pts.pos_w = torch.where(mvL[:, None], st.points, pts.pos_w)
        pts.optimized = pts.optimized | mvL
    ms = refresh_pixel_vectors(ms)
    return refresh_scene_depths(ms)


def apply_outliers(ms: MapState, outlier_mask) -> MapState:
    """Outlier routing (HandleOutliers): fixed points are exempt; a point
    with <= 2 measurements, or whose ROOT measurement is the outlier, goes
    bad; otherwise the measurement is removed, TRACKER/EPIPOLAR pairs enter
    the failure queue and the rest become never-retry.  Updates ms."""
    meas, pts = ms.meas, ms.points
    L = pts.capacity
    M, C = ms.no_retry.shape[:2]
    pt = meas.point.long()
    out = outlier_mask & meas.valid & ~pts.fixed[pt]
    counts_before = torch.zeros(L, dtype=torch.int32, device=pt.device)
    counts_before.index_add_(0, pt, meas.valid.to(torch.int32))
    kill = out & ((counts_before[pt] <= 2) | (meas.source == SRC_ROOT))
    killed_pt = _scatter_any(L, pt, kill)
    removed = out & ~killed_pt[pt]
    second_chance = removed & ((meas.source == SRC_TRACKER)
                               | (meas.source == SRC_EPIPOLAR))
    flat = (meas.mkf.long() * C + meas.cam.long()) * L + pt
    ms.retry_queue = ms.retry_queue | _scatter_any(
        M * C * L, flat, second_chance).reshape(M, C, L)
    ms.no_retry = ms.no_retry | _scatter_any(
        M * C * L, flat, removed & ~second_chance).reshape(M, C, L)
    out_inc = torch.zeros(L, dtype=torch.int32, device=pt.device)
    out_inc.index_add_(0, pt, (outlier_mask & meas.valid).to(torch.int32))
    pts.bad = pts.bad | (killed_pt & pts.valid & ~pts.fixed)
    pts.out_count = pts.out_count + out_inc
    meas.valid = meas.valid & ~removed
    return ms
