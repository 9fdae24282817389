"""The tracking slice of the standalone System (port of
mcptam_tpu/system/system.py, ref src/System.cc:169-303): batched
throughput tracking over a fixed map.

``process_frames`` runs, for each of B frames, the feature front-end, the
tracker, the point-statistics fold and the add-MKF heuristic, and emits one
packed 54-float scalar row per frame; the (B,54) block travels to the host
with one non-blocking copy and drains into FrameInfos ``pipeline_depth``
frames later.

Not in this slice: the map-maker (bundle adjustment, keyframe
integration), relocalisation and glare/static masks.  The System takes no
map-maker, so the map must be initialised by the caller (``ms`` +
``initialized = True``).  A drained frame that would need relocalisation,
or an add-MKF request while ``vars["AddingMKFs"]`` is on, raises
NotImplementedError instead of being skipped.
"""

from __future__ import annotations

import dataclasses
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
from mcptam_tpu_torch.map.state import count_mkfs, count_points, create_map_state
from mcptam_tpu_torch.tracker.tracker import (
    QUALITY_GOOD, apply_tracker_point_stats, create_tracker_state, track_frame,
)

N_SCALARS = 54  # lost, quality, add, found, points, mkfs, R(9), t(3), cov(36)
MM_RUNNING = 1  # the map-maker state FrameInfo reports (no map-maker here)


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


@dataclasses.dataclass
class TrackerTiming:
    """Section timers of a frame (ref msg/TrackerTiming.msg); the batched
    path fills only the map counters, as the reference's does."""
    kf_downsample: float = 0.0
    kf_feature: float = 0.0
    sbi: float = 0.0
    motion: float = 0.0
    pvs: float = 0.0
    coarse: float = 0.0
    fine: float = 0.0
    pose: float = 0.0
    depth: float = 0.0
    add: float = 0.0
    total: float = 0.0
    map_num_points: int = 0
    map_num_mkfs: int = 0


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


class System:
    """Batched multi-camera tracking over a map supplied by the caller."""

    def __init__(self, cams: CameraModel, cam_from_base: SE3,
                 cams_sbi: CameraModel, H: int, W: int,
                 tcfg: TrackerConfig = DEFAULT_TRACKER,
                 mcfg: MapMakerConfig = DEFAULT_MAPMAKER,
                 max_points: int = MAX_POINTS, max_mkfs: int = MAX_MKFS,
                 max_meas: int = MAX_MEAS, pipeline_depth: int = 0):
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
        self.initialized = False
        self.frame_count = 0
        self.vars = {"AddingMKFs": True}
        self.pipeline_depth = int(pipeline_depth)
        self._inflight = deque()

    # ------------------------------------------------------------------
    def _device_step(self, ts, ms, feats, cam_active):
        """Track one frame, fold point stats (gated on not-lost), evaluate
        the add-MKF heuristic, and pack every scalar the host reads into
        one (54,) row.  ``ms`` is updated in place (point tallies); the
        map-maker queue the reference also measures against is empty here."""
        ts2, res = track_frame(ts, ms, self.cams, self.cams_sbi, feats,
                               self.tcfg, cam_active=cam_active)
        ms = apply_tracker_point_stats(ms, res, self.mcfg.min_outliers,
                                       self.mcfg.outlier_multiplier,
                                       enable=~res.lost)
        add, _ = need_new_mkf(ms, res.pose, torch.mean(res.mean_depth), self.mcfg)
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

    def _batch_step(self, ts, ms, images_b, cam_active):
        """The B-frame step: a loop over frames carrying (ts, ms).  Returns
        (ts, ms, (B,54) scalars, per-frame TrackResults)."""
        rows, results = [], []
        for images in images_b:
            feats = make_frame_features(images)
            ts, ms, res, scalars = self._device_step(ts, ms, feats, cam_active)
            rows.append(scalars)
            results.append(res)
        return ts, ms, torch.stack(rows), results

    def process_frames(self, images_batch, cam_active=None) -> list:
        """Throughput mode: track B consecutive frames (B,C,H,W) uint8 or
        float in one step.  Returns the FrameInfos drained by this call, in
        frame order (possibly none while the pipeline primes)."""
        if not self.initialized:
            raise NotImplementedError(
                "map initialisation needs the map-maker, which is not ported; "
                "set System.ms and System.initialized")
        images_batch = torch.as_tensor(images_batch).to(self.device)
        B = int(images_batch.shape[0])
        if cam_active is None:
            cam_active = torch.ones(self.n_cams, dtype=torch.bool, device=self.device)
        else:
            cam_active = torch.as_tensor(cam_active, dtype=torch.bool).to(self.device)
        self.ts, self.ms, scal, _ = self._batch_step(
            self.ts, self.ms, images_batch, cam_active)
        if scal.is_cuda:
            host = torch.empty(scal.shape, dtype=scal.dtype, pin_memory=True)
            host.copy_(scal, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host, ready = scal, None
        self._inflight.append(_Batch(self.frame_count, host, ready, B))
        self.frame_count += B

        out = []
        while self._inflight and self._inflight_frames() > self.pipeline_depth:
            out.extend(self._drain_batch(self._inflight.popleft(), do_actions=True))
        return out

    def flush_pipeline(self) -> list:
        """Drain every in-flight frame, in order."""
        out = []
        while self._inflight:
            out.extend(self._drain_batch(self._inflight.popleft(), do_actions=True))
        return out

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
        """Unpack one drained batch into FrameInfos and check the control
        actions it implies, none of which this slice can run."""
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
                n_found=int(r[3]), mm_state=MM_RUNNING,
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
        if self.vars["AddingMKFs"] and any(
                bool(v[j][2]) and not i.lost for j, i in enumerate(infos)):
            raise NotImplementedError(
                "the tracker asks for a new keyframe and AddingMKFs is on; "
                "keyframe integration needs the map-maker, which is not ported")
        return infos
