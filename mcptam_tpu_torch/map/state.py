"""Map state: fixed-capacity struct-of-arrays (port of the tracking subset
of mcptam_tpu/map/state.py, ref src/Map.cc, MapPoint.h, KeyFrame.h).

A point, multi-keyframe (MKF) or measurement is a slot; ``valid`` masks
replace liveness.  Capacities are fixed at construction, so shapes never
depend on data.  Keyframe imagery is stored as uint8 pyramid atlases.
The map-maker's refind bookkeeping (``no_retry``, ``retry_queue``) replaces
the reference's never-retry sets and failure queue.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from mcptam_tpu_torch import config as cfg
from mcptam_tpu_torch.config import SBI_SIZE
from mcptam_tpu_torch.core import mest
from mcptam_tpu_torch.core.se3 import SE3
from mcptam_tpu_torch.ops.atlas import atlas_width

# Measurement sources (reference KeyFrame.h:100-117)
SRC_TRACKER = 0
SRC_REFIND = 1
SRC_ROOT = 2
SRC_TRAIL = 3
SRC_EPIPOLAR = 4


@dataclass
class PointArrays:
    pos_w: torch.Tensor          # (N,3) world position
    valid: torch.Tensor          # (N,) slot in use
    bad: torch.Tensor            # (N,) flagged bad
    fixed: torch.Tensor          # (N,)
    optimized: torch.Tensor      # (N,)
    src_mkf: torch.Tensor        # (N,) int32 source keyframe
    src_cam: torch.Tensor        # (N,) int32
    src_level: torch.Tensor      # (N,) int32
    center_xy: torch.Tensor      # (N,2) source-level patch centre
    src_window: torch.Tensor     # (N,SW,SW) uint8 source patch window
    src_window_ok: torch.Tensor  # (N,)
    center_nc: torch.Tensor      # (N,3) unit ray of the centre, source cam
    right_nc: torch.Tensor       # (N,3) one pixel right
    down_nc: torch.Tensor        # (N,3) one pixel down
    pixel_right_w: torch.Tensor  # (N,3) world-frame pixel footprint
    pixel_down_w: torch.Tensor   # (N,3)
    in_count: torch.Tensor       # (N,) int32 tracker inlier tally
    out_count: torch.Tensor      # (N,) int32

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]


@dataclass
class MKFArrays:
    base_from_world: SE3           # (M,)
    valid: torch.Tensor            # (M,)
    fixed: torch.Tensor            # (M,)
    kf_valid: torch.Tensor         # (M,C)
    scene_depth_mean: torch.Tensor   # (M,C)
    scene_depth_sigma: torch.Tensor  # (M,C)
    atlas: torch.Tensor            # (M,C,H,AW) uint8
    corner_atlas: torch.Tensor     # (M,C,H,AW) uint8 0/1
    sbi: torch.Tensor              # (M,C,ROWS,COLS)
    sbi_gx: torch.Tensor
    sbi_gy: torch.Tensor
    seq: torch.Tensor              # (M,) int32 insertion sequence (-1 none)

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]


@dataclass
class MeasArrays:
    mkf: torch.Tensor     # (K,) int32
    cam: torch.Tensor     # (K,) int32
    point: torch.Tensor   # (K,) int32
    level: torch.Tensor   # (K,) int32
    uv_l0: torch.Tensor   # (K,2) level-0 image position
    valid: torch.Tensor   # (K,)
    source: torch.Tensor  # (K,) int32 SRC_*
    subpix: torch.Tensor  # (K,)

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]


@dataclass
class MapState:
    points: PointArrays
    mkfs: MKFArrays
    meas: MeasArrays
    cam_from_base: SE3    # (C,) rig extrinsics
    next_seq: torch.Tensor  # () int32
    # per-(KF, point) refind bookkeeping (MapMakerData::spNeverRetryKFs and
    # mlFailureQueue, src/MapMakerServerBase.cc:921-1003,1063-1080,1198-1247)
    no_retry: torch.Tensor     # (M,C,N) pair failed a refind: never again
    retry_queue: torch.Tensor  # (M,C,N) outlier pair awaiting a 2nd chance


def clone_tree(obj):
    """Deep copy of a dataclass tree of tensors (a MapState before a
    speculative integration, which updates its argument in place)."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: clone_tree(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, tuple):
        return tuple(clone_tree(v) for v in obj)
    return obj


def create_map_state(H: int, W: int, n_cams: int, cam_from_base: SE3,
                     max_points: int = cfg.MAX_POINTS,
                     max_mkfs: int = cfg.MAX_MKFS,
                     max_meas: int = cfg.MAX_MEAS, device=None) -> MapState:
    N, M, K, C = max_points, max_mkfs, max_meas, n_cams
    device = cam_from_base.t.device if device is None else device
    AW = atlas_width(W)
    ROWS, COLS = SBI_SIZE
    i32, b, u8 = torch.int32, torch.bool, torch.uint8

    def z(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    points = PointArrays(
        pos_w=z((N, 3)), valid=z(N, b), bad=z(N, b), fixed=z(N, b),
        optimized=z(N, b), src_mkf=z(N, i32), src_cam=z(N, i32),
        src_level=z(N, i32), center_xy=z((N, 2)),
        src_window=z((N, cfg.SRC_WINDOW, cfg.SRC_WINDOW), u8),
        src_window_ok=z(N, b), center_nc=z((N, 3)), right_nc=z((N, 3)),
        down_nc=z((N, 3)), pixel_right_w=z((N, 3)), pixel_down_w=z((N, 3)),
        in_count=z(N, i32), out_count=z(N, i32),
    )
    mkfs = MKFArrays(
        base_from_world=SE3.identity((M,), device=device),
        valid=z(M, b), fixed=z(M, b), kf_valid=z((M, C), b),
        scene_depth_mean=torch.ones((M, C), device=device),
        scene_depth_sigma=torch.ones((M, C), device=device),
        atlas=z((M, C, H, AW), u8), corner_atlas=z((M, C, H, AW), u8),
        sbi=z((M, C, ROWS, COLS)), sbi_gx=z((M, C, ROWS, COLS)),
        sbi_gy=z((M, C, ROWS, COLS)),
        seq=torch.full((M,), -1, dtype=i32, device=device),
    )
    meas = MeasArrays(
        mkf=z(K, i32), cam=z(K, i32), point=z(K, i32), level=z(K, i32),
        uv_l0=z((K, 2)), valid=z(K, b), source=z(K, i32), subpix=z(K, b),
    )
    return MapState(
        points=points, mkfs=mkfs, meas=meas,
        cam_from_base=SE3(R=cam_from_base.R.to(device).clone(),
                          t=cam_from_base.t.to(device).clone()),
        next_seq=z((), i32),
        no_retry=z((M, C, N), b), retry_queue=z((M, C, N), b),
    )


def alloc_slots(free: torch.Tensor, want: torch.Tensor):
    """Assign a free slot to each wanted item, in order.

    free: (N,) bool free-slot mask; want: (Q,) bool requests.
    Returns (slot_idx (Q,) int64, ok (Q,) bool); unplaceable items get
    ok=False (callers mask their scatters with ok)."""
    N = free.shape[0]
    ar = torch.arange(N, device=free.device)
    order = torch.sort(torch.where(free, ar, torch.full_like(ar, N))).values
    rank = torch.cumsum(want.to(torch.int64), 0) - 1
    rank = torch.where(want, rank, torch.zeros_like(rank))
    slot = order[torch.clamp(rank, 0, N - 1)]
    ok = want & (slot < N) & (rank < torch.sum(free))
    return slot, ok


def kf_cam_from_world(ms: MapState) -> SE3:
    """(M,C) camera-from-world of every keyframe slot."""
    base = ms.mkfs.base_from_world
    cam = ms.cam_from_base
    R = torch.einsum("cij,mjk->mcik", cam.R, base.R)
    t = torch.einsum("cij,mj->mci", cam.R, base.t) + cam.t[None]
    return SE3(R=R, t=t)


def refresh_pixel_vectors(ms: MapState) -> MapState:
    """Recompute every point's world-frame pixel footprint vectors
    (MapPoint::RefreshPixelVectors, src/MapPoint.cc:61-87).  Updates the
    point arrays in place."""
    pts = ms.points
    kcw = kf_cam_from_world(ms)
    m, c = pts.src_mkf.long(), pts.src_cam.long()
    src = SE3(R=kcw.R[m, c], t=kcw.t[m, c])
    p_c = src.apply(pts.pos_w)
    cam_height = torch.abs(p_c[..., 2])

    def on_plane(ray):
        rate = torch.abs(ray[..., 2])
        rate = torch.where(rate < 1e-9, torch.full_like(rate, 1e-9), rate)
        return ray * (cam_height / rate)[..., None]

    center_pl = on_plane(pts.center_nc)
    Rt = src.R.transpose(-1, -2)
    pts.pixel_right_w = torch.einsum("nij,nj->ni", Rt, on_plane(pts.right_nc) - center_pl)
    pts.pixel_down_w = torch.einsum("nij,nj->ni", Rt, on_plane(pts.down_nc) - center_pl)
    return ms


def refresh_scene_depths(ms: MapState) -> MapState:
    """Robust per-keyframe scene depth from the measured points
    (KeyFrame::RefreshSceneDepthRobust, src/KeyFrame.cc:585-645).  Updates
    the MKF arrays in place."""
    M = ms.mkfs.capacity
    C = ms.cam_from_base.t.shape[0]
    N = ms.points.capacity
    kcw = kf_cam_from_world(ms)
    p_c = (torch.einsum("mcij,nj->mcni", kcw.R, ms.points.pos_w)
           + kcw.t[:, :, None, :])
    depths = torch.linalg.vector_norm(p_c, dim=-1)               # (M,C,N)

    meas = ms.meas
    meas_ok = meas.valid & ms.points.valid[meas.point.long()]
    flat = (meas.mkf.long() * C + meas.cam.long()) * N + meas.point.long()
    mk = torch.zeros(M * C * N, dtype=torch.int32, device=depths.device)
    mk = mk.scatter_reduce(0, flat, meas_ok.to(torch.int32), reduce="amax")

    flatd = depths.reshape(M * C, N)
    flatm = mk.reshape(M * C, N) > 0
    med = mest.masked_median_bisect(flatd, flatm)
    dist_sq = (flatd - med[:, None]) ** 2
    sig_sq = torch.clamp(mest.find_sigma_squared(dist_sq, flatm), min=0.4)
    w = torch.sqrt(mest.weight(mest.HUBER, dist_sq, sig_sq[:, None])) * flatm
    sw = torch.clamp(torch.sum(w, -1), min=1e-9)
    mean = torch.sum(w * flatd, -1) / sw
    var = torch.sum(w * flatd * flatd, -1) / sw - mean * mean
    sigma = torch.sqrt(torch.clamp(var, min=1e-12))
    enough = torch.sum(flatm, -1) > 3
    mkfs = ms.mkfs
    mkfs.scene_depth_mean = torch.where(
        enough, mean, mkfs.scene_depth_mean.reshape(-1)).reshape(M, C)
    mkfs.scene_depth_sigma = torch.where(
        enough, sigma, mkfs.scene_depth_sigma.reshape(-1)).reshape(M, C)
    return ms


def pose_depth_distance(pose_a: SE3, mean_depth_a, pose_b: SE3, depth_b):
    """Depth-aware distance between base poses (KeyFrame::Distance,
    src/KeyFrame.cc:715-747): |camPos diff| + 0.5 |meanDepthPoint diff|.
    pose_b/depth_b may be batched."""
    frac = 0.5  # sdDistanceMeanDiffFraction default
    a_inv = pose_a.inv()
    b_inv = pose_b.inv()
    d_cam = torch.linalg.vector_norm(b_inv.t - a_inv.t, dim=-1)
    zero = torch.zeros_like(mean_depth_a)
    pa = a_inv.apply(torch.stack([zero, zero, mean_depth_a], -1))
    zb = torch.zeros_like(depth_b)
    pb = b_inv.apply(torch.stack([zb, zb, depth_b], -1))
    return d_cam + frac * torch.linalg.vector_norm(pb - pa, dim=-1)


def mkf_distance(ms: MapState, pose_a: SE3, mean_depth_a, idx_b):
    """pose_depth_distance between a query pose and MKF slots idx_b."""
    mk = ms.mkfs
    pose_b = mk.base_from_world[idx_b]
    kfv = mk.kf_valid[idx_b]
    depth_b = torch.mean(
        torch.where(kfv, mk.scene_depth_mean[idx_b],
                    torch.zeros_like(mk.scene_depth_mean[idx_b])), -1
    ) / torch.clamp(torch.mean(kfv.to(torch.float32), -1), min=1e-9)
    return pose_depth_distance(pose_a, mean_depth_a, pose_b, depth_b)


def closest_mkf_distance(ms: MapState, pose: SE3, mean_depth):
    """Min depth-scaled distance to any valid MKF and its slot
    (MapMakerBase::ClosestMultiKeyFrame, src/MapMakerClientBase.cc:111-152)."""
    M = ms.mkfs.capacity
    d = mkf_distance(ms, pose, mean_depth,
                     torch.arange(M, device=ms.mkfs.valid.device))
    d = torch.where(ms.mkfs.valid, d, torch.full_like(d, float("inf")))
    return torch.min(d), torch.argmin(d)


def point_depths_in_kf(ms: MapState, mkf_idx, cam_idx):
    """Depths (norm of the camera-frame position) of every point in the
    keyframe (mkf_idx, cam_idx), and the camera-frame positions."""
    kcw = kf_cam_from_world(ms)
    pose = SE3(R=kcw.R[mkf_idx, cam_idx], t=kcw.t[mkf_idx, cam_idx])
    p_c = pose.apply(ms.points.pos_w)
    return torch.linalg.vector_norm(p_c, dim=-1), p_c


def kf_distance_table(ms: MapState, mkf_idx, cam_idx):
    """(M,C) depth-aware distances from keyframe (mkf_idx, cam_idx) to
    every keyframe slot (KeyFrame::Distance, src/KeyFrame.cc:715-747):
    |camPos diff| + 0.5 |meanDepthPoint diff|, each keyframe contributing
    the point at its own scene depth on its optical axis."""
    frac = 0.5  # sdDistanceMeanDiffFraction default
    inv = kf_cam_from_world(ms).inv()
    pos = inv.t                                      # (M,C,3) camera centres
    depth = ms.mkfs.scene_depth_mean
    z = torch.zeros_like(depth)
    dpt = inv.apply(torch.stack([z, z, depth], -1))  # (M,C,3)
    d_cam = torch.linalg.vector_norm(pos - pos[mkf_idx, cam_idx], dim=-1)
    d_mean = torch.linalg.vector_norm(dpt - dpt[mkf_idx, cam_idx], dim=-1)
    return d_cam + frac * d_mean


def closest_kf(ms: MapState, mkf_idx, cam_idx, region: str):
    """Closest valid keyframe to (mkf_idx, cam_idx) within a region
    (MapMakerBase::ClosestKeyFrame, src/MapMakerBase.cc:90-151): 'other' =
    keyframes of every other MKF, 'self' = sibling keyframes of the same
    MKF.  Returns (tgt_mkf, tgt_cam, found), device scalars."""
    M = ms.mkfs.capacity
    C = ms.cam_from_base.t.shape[0]
    dev = ms.mkfs.valid.device
    d = kf_distance_table(ms, mkf_idx, cam_idx)
    ok = ms.mkfs.valid[:, None] & ms.mkfs.kf_valid
    same_mkf = torch.arange(M, device=dev)[:, None] == mkf_idx
    same_cam = torch.arange(C, device=dev)[None, :] == cam_idx
    if region == "other":
        ok = ok & ~same_mkf
    elif region == "self":
        ok = ok & same_mkf & ~same_cam
    else:
        ok = ok & ~(same_mkf & same_cam)
    d = torch.where(ok, d, torch.full_like(d, float("inf"))).reshape(-1)
    flat = torch.argmin(d)  # first minimum, as jnp.argmin
    return ((flat // C).to(torch.int32), (flat % C).to(torch.int32),
            torch.isfinite(d[flat]))


def move_bad_points_to_trash(ms: MapState) -> MapState:
    """Clear bad points and their measurements (Map::MoveBadPointsToTrash
    + EmptyTrash in one step); freed slots drop their refind bookkeeping.
    Updates ms in place."""
    bad = ms.points.bad
    ms.points.valid = ms.points.valid & ~bad
    ms.meas.valid = ms.meas.valid & ~bad[ms.meas.point.long()]
    ms.points.bad = torch.zeros_like(bad)
    keep = ~bad[None, None, :]
    ms.no_retry = ms.no_retry & keep
    ms.retry_queue = ms.retry_queue & keep
    return ms


def count_points(ms: MapState):
    return torch.sum(ms.points.valid & ~ms.points.bad)


def count_mkfs(ms: MapState):
    return torch.sum(ms.mkfs.valid)
