"""The standalone System in throughput mode (port of
mcptam_tpu/system/system.py, ref src/System.cc:169-303): batched tracking
with the map-maker ticking between batches.

``process_frames`` runs, for each of B frames, the feature front-end, the
tracker, the point-statistics fold and the add-MKF heuristic (distance to
the map's MKFs and to those still queued in the map-maker), and emits one
packed 54-float scalar row per frame; the (B,54) block travels to the host
with one non-blocking copy and drains into FrameInfos ``pipeline_depth``
frames later.  A drained batch queues at most one new MKF (its newest
qualifying frame, with that frame's tracker result), and every
``tick_every``-th batch runs one map-maker tick (``system/mapmaker.py``).

Not in this slice: map bootstrap and the synchronous ``process_frame``
path, relocalisation, glare and static masks, and the failed-map dump.
The caller supplies the map (``ms`` + ``initialized = True``); a drained
frame that would need relocalisation raises NotImplementedError.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from mcptam_tpu_torch.config import (
    DEFAULT_MAPMAKER, DEFAULT_TRACKER, MAX_MEAS, MAX_MKFS, MAX_POINTS,
    MapMakerConfig, TrackerConfig,
)
from mcptam_tpu_torch.core.camera import CameraModel
from mcptam_tpu_torch.core.se3 import SE3
from mcptam_tpu_torch.map.keyframe import make_frame_features
from mcptam_tpu_torch.map.mapmaker_core import need_new_mkf
from mcptam_tpu_torch.map.state import (
    count_mkfs, count_points, create_map_state, pose_depth_distance,
)
from mcptam_tpu_torch.system.mapmaker import MapMaker
from mcptam_tpu_torch.system.timing import TrackerTiming
from mcptam_tpu_torch.tracker.tracker import (
    QUALITY_GOOD, apply_tracker_point_stats, create_tracker_state, track_frame,
)

N_SCALARS = 54  # lost, quality, add, found, points, mkfs, R(9), t(3), cov(36)
QUEUE_SLOTS = 2  # queued-MKF poses the add heuristic measures against


def publish_pose_cov(pose34: np.ndarray, cov: np.ndarray,
                     quality: int) -> np.ndarray:
    """The published pose covariance (ref PublishPose,
    src/SystemFrontendBase.cc:160-197): cross-correlation cleared, both 3x3
    blocks rotated from the base frame into the world frame, then inflated
    by tracking grade — x1e2 GOOD, x1e5 DODGY, x1e8 BAD."""
    R = np.asarray(pose34[:, :3]).T
    c = np.array(cov, dtype=np.float64)
    c[:3, 3:] = 0.0
    c[3:, :3] = 0.0
    c[:3, :3] = R @ c[:3, :3] @ R.T
    c[3:, 3:] = R @ c[3:, 3:] @ R.T
    return c * (1e2, 1e5, 1e8)[int(quality)]


@dataclass
class FrameInfo:
    pose: np.ndarray          # (3,4) base_from_world
    cov: np.ndarray           # (6,6) world-frame, quality-inflated
    cov_raw: np.ndarray       # (6,6) tracker H^-1 in the base frame
    quality: int
    lost: bool
    relocalized: bool
    n_points: int
    n_mkfs: int
    n_found: int
    mm_state: int
    timing: TrackerTiming
    added_mkf: bool
    frame_id: int = -1        # lags the newest dispatched frame


@dataclass
class _Batch:
    """One dispatched batch awaiting its drain."""
    fid0: int
    scalars: torch.Tensor     # (B,54) host copy, valid once `ready` fired
    ready: object             # torch.cuda.Event, or None on the CPU
    n: int
    images: torch.Tensor = None   # (B,C,H,W) for an add's features
    results: list = None          # per-frame TrackResults, on the device
    cam_active: torch.Tensor = None


class System:
    """Batched multi-camera tracking and mapping over a map supplied by the
    caller."""

    def __init__(self, cams: CameraModel, cam_from_base: SE3,
                 cams_sbi: CameraModel, H: int, W: int,
                 tcfg: TrackerConfig = DEFAULT_TRACKER,
                 mcfg: MapMakerConfig = DEFAULT_MAPMAKER,
                 max_points: int = MAX_POINTS, max_mkfs: int = MAX_MKFS,
                 max_meas: int = MAX_MEAS, mapmaker=None, pipeline_depth: int = 0):
        self.cams = cams
        self.cam_from_base = cam_from_base
        self.cams_sbi = cams_sbi
        self.H, self.W = H, W
        self.n_cams = int(cam_from_base.t.shape[0])
        self.device = cam_from_base.t.device
        self.tcfg = tcfg
        self.mcfg = mcfg
        self.ms = create_map_state(H, W, self.n_cams, cam_from_base,
                                   max_points, max_mkfs, max_meas)
        self.ts = create_tracker_state(self.n_cams, self.device)
        self.mapmaker = mapmaker or MapMaker(cams=cams, mcfg=mcfg)
        self.initialized = False
        self.frame_count = 0
        self.vars = {"AddingMKFs": True}
        self.pipeline_depth = int(pipeline_depth)
        self.tick_every = 1     # map-maker tick every Nth batch
        self._batch_count = 0
        self._inflight = deque()
        self.last_reset_dropped = 0
        eye = torch.eye(3, device=self.device)
        self._empty_queue_poses = (
            eye.expand(QUEUE_SLOTS, 3, 3), torch.zeros(QUEUE_SLOTS, 3, device=self.device),
            torch.ones(QUEUE_SLOTS, device=self.device),
            torch.zeros(QUEUE_SLOTS, dtype=torch.bool, device=self.device))

    # ------------------------------------------------------------------
    def _device_step(self, ts, ms, feats, cam_active, queue_poses):
        """Track one frame, fold point stats (gated on not-lost), evaluate
        the add-MKF heuristic against the map's MKFs and the queued ones,
        and pack every scalar the host reads into one (54,) row.  ``ms`` is
        updated in place (point tallies).

        queue_poses: (qR (Q,3,3), qt (Q,3), qdepth (Q,), qvalid (Q,)), the
        MKFs still in the map-maker queue (NeedNewMultiKeyFrame,
        src/MapMakerClientBase.cc:111-152)."""
        ts2, res = track_frame(ts, ms, self.cams, self.cams_sbi, feats,
                               self.tcfg, cam_active=cam_active)
        ms = apply_tracker_point_stats(ms, res, self.mcfg.min_outliers,
                                       self.mcfg.outlier_multiplier,
                                       enable=~res.lost)
        mean_depth = torch.mean(res.mean_depth)
        qR, qt, qdepth, qvalid = queue_poses
        dq = pose_depth_distance(res.pose, mean_depth, SE3(R=qR, t=qt), qdepth)
        queue_dist = torch.min(torch.where(qvalid, dq, torch.full_like(dq, float("inf"))))
        add, _ = need_new_mkf(ms, res.pose, mean_depth, self.mcfg,
                              queue_dist=queue_dist)
        add = add & (res.quality == QUALITY_GOOD) & ~res.lost
        f32 = torch.float32
        scalars = torch.cat([
            torch.stack([
                res.lost.to(f32), res.quality.to(f32), add.to(f32),
                res.tot_found.to(f32), count_points(ms).to(f32),
                count_mkfs(ms).to(f32),
            ]),
            res.pose.R.reshape(-1), res.pose.t, res.cov.reshape(-1),
        ])
        return ts2, ms, res, scalars

    def _queue_poses(self):
        """Queued-MKF poses and depths in the static distance slots; the
        all-empty constant serves the common empty-queue batch."""
        queue = self.mapmaker.queue[:QUEUE_SLOTS]
        if not queue:
            return self._empty_queue_poses
        qR, qt, qd, qv = (list(x.unbind(0)) for x in self._empty_queue_poses)
        for i, (_, qpose, qres, _) in enumerate(queue):
            qR[i], qt[i] = qpose.R, qpose.t
            qd[i] = (torch.mean(qres.mean_depth) if qres is not None
                     else torch.ones((), device=self.device))
            qv[i] = torch.ones((), dtype=torch.bool, device=self.device)
        return tuple(torch.stack(x) for x in (qR, qt, qd, qv))

    def _batch_step(self, ts, ms, images_b, cam_active, queue_poses=None):
        """The B-frame step: a loop over frames carrying (ts, ms).  Returns
        (ts, ms, (B,54) scalars, per-frame TrackResults)."""
        if queue_poses is None:
            queue_poses = self._empty_queue_poses
        rows, results = [], []
        for images in images_b:
            feats = make_frame_features(images)
            ts, ms, res, scalars = self._device_step(ts, ms, feats, cam_active,
                                                     queue_poses)
            rows.append(scalars)
            results.append(res)
        return ts, ms, torch.stack(rows), results

    def process_frame(self, images, cam_active=None):
        """The synchronous one-frame path (with its minipatch candidate
        filter and map bootstrap) is not in this slice."""
        raise NotImplementedError("the synchronous process_frame path is not "
                                  "ported; use process_frames")

    def process_frames(self, images_batch, cam_active=None) -> list:
        """Throughput mode: track B consecutive frames (B,C,H,W) uint8 or
        float in one step.  Returns the FrameInfos drained by this call, in
        frame order (possibly none while the pipeline primes)."""
        if not self.initialized:
            raise NotImplementedError(
                "map bootstrap is not ported; set System.ms and "
                "System.initialized")
        images_batch = torch.as_tensor(images_batch).to(self.device)
        B = int(images_batch.shape[0])
        if cam_active is None:
            cam_active = torch.ones(self.n_cams, dtype=torch.bool, device=self.device)
        else:
            cam_active = torch.as_tensor(cam_active, dtype=torch.bool).to(self.device)
        self.ts, self.ms, scal, results = self._batch_step(
            self.ts, self.ms, images_batch, cam_active, self._queue_poses())
        if scal.is_cuda:
            host = torch.empty(scal.shape, dtype=scal.dtype, pin_memory=True)
            host.copy_(scal, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host, ready = scal, None
        self._inflight.append(_Batch(self.frame_count, host, ready, B,
                                     images_batch, results, cam_active))
        self.frame_count += B

        out = []
        while self._inflight and self._inflight_frames() > self.pipeline_depth:
            out.extend(self._drain_batch(self._inflight.popleft(), do_actions=True))

        # map-maker tick, every tick_every-th batch (on one device BA chunks
        # serialise with tracking, so this is the throughput dial)
        self._batch_count += 1
        if self._batch_count % max(int(self.tick_every), 1) == 0:
            budget = self.mcfg.duty_budget_ms
            self.ms = self.mapmaker.step(
                self.ms, budget_s=budget * 1e-3 if budget > 0 else None)
        if any(i.added_mkf for i in out):
            self.mapmaker.on_map_changed()
        if self.mapmaker.reset_requested:
            self._reset_after_failed_ba()
        return out

    def _reset_after_failed_ba(self):
        if self.mcfg.fail_dump_path:
            raise NotImplementedError("the failed-map dump (mapio) is not ported")
        self.reset(keep_pose=True)

    def flush_pipeline(self) -> list:
        """Drain every in-flight frame, in order, then integrate every MKF
        still queued."""
        out = []
        while self._inflight:
            out.extend(self._drain_batch(self._inflight.popleft(), do_actions=True))
        if any(i.added_mkf for i in out):
            self.mapmaker.on_map_changed()
        while self.mapmaker.queue:
            self.ms = self.mapmaker.step(self.ms)
        return out

    def reset(self, keep_pose: bool = False):
        """Full reset (ref Reset service): a fresh map and tracker, the
        map-maker cleared, in-flight frames dropped and counted."""
        self.last_reset_dropped = self._inflight_frames()
        pose = self.ts.pose if keep_pose else SE3.identity(device=self.device)
        self.ms = create_map_state(self.H, self.W, self.n_cams, self.cam_from_base,
                                   self.ms.points.capacity, self.ms.mkfs.capacity,
                                   self.ms.meas.capacity)
        self.ts = create_tracker_state(self.n_cams, self.device)
        self.ts.pose = pose
        self.mapmaker.reset(self.ms)
        self.initialized = False
        self._inflight.clear()

    def _inflight_frames(self) -> int:
        return sum(b.n for b in self._inflight)

    def _newer_frame_recovered(self) -> bool:
        """True when a newer in-flight frame whose scalars have already
        landed reports not-lost (never blocks the pipeline)."""
        for b in self._inflight:
            if b.ready is None or b.ready.query():
                if bool(np.any(b.scalars[:, 0].numpy() < 0.5)):
                    return True
        return False

    def _drain_batch(self, entry: _Batch, do_actions: bool) -> list:
        """Unpack one drained batch into FrameInfos and run its control
        actions: at most one keyframe add, the newest qualifying frame
        (features recomputed, pose and tracker measurements from its
        TrackResult)."""
        if entry.ready is not None:
            entry.ready.synchronize()
        v = entry.scalars.numpy()
        infos = []
        for j in range(v.shape[0]):
            r = v[j]
            pose34 = np.concatenate([r[6:15].reshape(3, 3), r[15:18][:, None]], 1)
            cov = r[18:54].reshape(6, 6)
            infos.append(FrameInfo(
                pose=pose34, cov=publish_pose_cov(pose34, cov, int(r[1])),
                cov_raw=cov, quality=int(r[1]), lost=bool(r[0]),
                relocalized=False, n_points=int(r[4]), n_mkfs=int(r[5]),
                n_found=int(r[3]), mm_state=self.mapmaker.state,
                timing=TrackerTiming(map_num_points=int(r[4]),
                                     map_num_mkfs=int(r[5])),
                added_mkf=False, frame_id=entry.fid0 + j,
            ))
        if not do_actions:
            return infos
        if infos[-1].lost and not self._newer_frame_recovered():
            raise NotImplementedError(
                f"frame {infos[-1].frame_id} is lost and needs relocalisation, "
                "which is not ported")
        want = [j for j, i in enumerate(infos) if bool(v[j][2]) and not i.lost]
        if self.vars["AddingMKFs"] and want and self.mapmaker.queue_size() <= 2:
            j = want[-1]
            feats = make_frame_features(entry.images[j].to(torch.float32))
            res = entry.results[j]
            self.mapmaker.add_mkf(feats, res.pose, res, cam_active=entry.cam_active)
            infos[j].added_mkf = True
        return infos
