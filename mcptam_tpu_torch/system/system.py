"""The standalone System: tracker and map-maker in one process (port of
mcptam_tpu/system/system.py, ref src/System.cc:169-303).

Two entry points share one device step (features, tracker, point
statistics, the add-MKF heuristic against the map's MKFs and those still
queued in the map-maker, one packed 54-float scalar row per frame):

* ``process_frame``, the live session: one frame at a time.  The first
  frames bootstrap the map (``MapMaker.init``, retried until enough points
  triangulate); a lost frame tries relocalisation; a keyframe add first
  prunes the frame's candidates with the MiniPatch stability filter
  against the previous frame; the map-maker ticks once per frame.
* ``process_frames``, the throughput mode: B frames per call, at most one
  keyframe add per drained batch, a map-maker tick every ``tick_every``-th
  batch.  On an uninitialised map it falls back to ``process_frame``.

Each frame's scalar row travels to the host with one non-blocking copy and
drains into a FrameInfo ``pipeline_depth`` frames later; control actions
run when a frame drains.  Static masks and glare masking exclude image
regions from the features; ``save``/``load`` checkpoint the session in the
JAX package's npz layout (``system/mapio.py``).

Spans (``system/timing.py``) mark the step's stages: ``system.batch_step``
and ``system.device_step`` around the step, per frame ``frontend.features``,
``tracker.track_frame`` (its stages inside) and ``system.frame_tail``, and
``system.drain_wait`` around a drain's wait; a FrameInfo's ``timing`` holds
its frame's spans while the tracer is on.

Beside them: ``profile_frame`` (one frame's device step under the tracer's
synchronous mode, each stage timed to a device synchronise), the GUI
console ``parse_line`` (the reference's command vocabulary and
``Name=Value`` variables), the monitor images
``small_image`` and ``keyframe_view``, and the map commands
``rescale_map`` and ``align_to_dominant_plane``.
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
from mcptam_tpu_torch.map.align import (
    apply_global_scale, apply_global_transform, plane_align_transform,
)
from mcptam_tpu_torch.map.keyframe import FrameFeatures, make_frame_features
from mcptam_tpu_torch.map.mapmaker_core import need_new_mkf
from mcptam_tpu_torch.map.state import (
    count_mkfs, count_points, create_map_state, pose_depth_distance,
)
from mcptam_tpu_torch.ops.minipatch import filter_frame_candidates
from mcptam_tpu_torch.system.mapio import (
    dump_cameras_ascii, dump_map_ascii, load_map, save_map,
)
from mcptam_tpu_torch.system.mapmaker import MM_INITIALIZING, MapMaker, _to_host
from mcptam_tpu_torch.system import timing
from mcptam_tpu_torch.system.timing import TrackerTiming, frame_timings, span
from mcptam_tpu_torch.system.viewer import frame_small_image, keyframe_overlay
from mcptam_tpu_torch.tracker.reloc import attempt_recovery
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
    provisional: bool = False  # pipeline priming: published again on drain
    # a batch drained by process_frame: its older frames, in order
    siblings: list = None


@dataclass
class _Frame:
    """One process_frame step awaiting its drain."""
    fid: int
    scalars: torch.Tensor     # (54,) host copy, valid once `ready` fired
    ready: object             # torch.cuda.Event, or None on the CPU
    feats: FrameFeatures
    result: object            # TrackResult, on the device
    cam_active: torch.Tensor
    n: int = 1
    timing: TrackerTiming = None  # from its spans; None while the tracer is off


@dataclass
class _Batch:
    """One dispatched process_frames batch awaiting its drain."""
    fid0: int
    scalars: torch.Tensor     # (B,54) host copy, valid once `ready` fired
    ready: object             # torch.cuda.Event, or None on the CPU
    n: int
    images: torch.Tensor = None   # (B,C,H,W) for an add's features
    results: list = None          # per-frame TrackResults, on the device
    cam_active: torch.Tensor = None
    timings: dict = None          # frame id -> TrackerTiming, from its spans


class System:
    """Multi-camera tracking and mapping."""

    def __init__(self, cams: CameraModel, cam_from_base: SE3,
                 cams_sbi: CameraModel, H: int, W: int,
                 tcfg: TrackerConfig = DEFAULT_TRACKER,
                 mcfg: MapMakerConfig = DEFAULT_MAPMAKER,
                 max_points: int = MAX_POINTS, max_mkfs: int = MAX_MKFS,
                 max_meas: int = MAX_MEAS, mapmaker=None, masks=None,
                 pipeline_depth: int = 0):
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
        # runtime variables (the reference's GVars3, src/System.cc:114-131)
        self.vars = {
            "DrawLevel": 0,
            "GlareMasking": False,
            "AddingMKFs": True,
            "CrossCamera": mcfg.cross_camera,
            "LevelZeroPoints": mcfg.level_zero_points,
        }
        # static feature-exclusion masks, True where usable (ref SystemBase
        # mask loading, src/SystemBase.cc:218-248)
        self._static_masks = (None if masks is None else
                              torch.as_tensor(masks).to(self.device, torch.bool))
        self.pipeline_depth = int(pipeline_depth)
        self.tick_every = 1     # map-maker tick every Nth batch
        self._batch_count = 0
        self._inflight = deque()
        self.last_reset_dropped = 0
        self._force_add_next = False   # ManualAddMKF request
        self._prev_feats = None        # the candidate filter's previous frame
        self._last_result = None       # its TrackResult, for the monitor image
        self.done = False              # the quit / exit command's latch
        self._kf_view = 0              # the KeyFrameViewer's cursor
        # frames dispatched before the last successful relocalisation carry
        # stale lost flags: draining them must not relocalise again
        self._reloc_done_fid = -1
        eye = torch.eye(3, device=self.device)
        self._empty_queue_poses = (
            eye.expand(QUEUE_SLOTS, 3, 3), torch.zeros(QUEUE_SLOTS, 3, device=self.device),
            torch.ones(QUEUE_SLOTS, device=self.device),
            torch.zeros(QUEUE_SLOTS, dtype=torch.bool, device=self.device))

    # ------------------------------------------------------------------
    def _features(self, images) -> FrameFeatures:
        return make_frame_features(images, static_masks=self._static_masks,
                                   glare_masking=bool(self.vars["GlareMasking"]))

    def _reloc_fn(self, ms, feats, cam_active):
        return attempt_recovery(ms, self.cams_sbi, feats, cam_active=cam_active)

    def _cam_active(self, cam_active) -> torch.Tensor:
        if cam_active is None:
            return torch.ones(self.n_cams, dtype=torch.bool, device=self.device)
        return torch.as_tensor(cam_active).to(self.device, torch.bool)

    def set_var(self, name: str, value):
        """Set a runtime variable (GVars3 analogue): DrawLevel is the
        monitor image's pyramid level, GlareMasking masks the next frames'
        features, AddingMKFs gates keyframe adds, CrossCamera
        and LevelZeroPoints set the point-creation policy of later MKFs."""
        if name not in self.vars:
            raise KeyError(f"unknown var {name!r}; have {sorted(self.vars)}")
        self.vars[name] = value
        if name in ("CrossCamera", "LevelZeroPoints"):
            self.mcfg = dataclasses.replace(
                self.mcfg, cross_camera=bool(self.vars["CrossCamera"]),
                level_zero_points=bool(self.vars["LevelZeroPoints"]))
            self.mapmaker.mcfg = self.mcfg

    def get_var(self, name: str):
        return self.vars[name]

    def manual_add_mkf(self):
        """The ManualAddMKF command (src/System.cc:305-405): during map
        initialisation it ends the initialisation; afterwards the next frame
        that is not lost becomes a keyframe, whatever the add heuristic says
        (ref mbAddNext, src/Tracker.cc:470-487)."""
        if self.mapmaker.state == MM_INITIALIZING:
            self.mapmaker.stop_init()
        else:
            self._force_add_next = True

    @property
    def pose(self) -> SE3:
        return self.ts.pose

    def _device_step(self, ts, ms, feats, cam_active, queue_poses, fid=None):
        """Track one frame, fold point stats (gated on not-lost), evaluate
        the add-MKF heuristic against the map's MKFs and the queued ones,
        and pack every scalar the host reads into one (54,) row.  ``ms`` is
        updated in place (point tallies).  ``fid`` labels the frame's spans.

        queue_poses: (qR (Q,3,3), qt (Q,3), qdepth (Q,), qvalid (Q,)), the
        MKFs still in the map-maker queue (NeedNewMultiKeyFrame,
        src/MapMakerClientBase.cc:111-152)."""
        with span("tracker.track_frame", fid):
            ts2, res = track_frame(ts, ms, self.cams, self.cams_sbi, feats,
                                   self.tcfg, cam_active=cam_active)
        with span("system.frame_tail", fid):
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

    def _frame_step(self, images, cam_active, bootstrap: bool):
        """One frame's device step (``system.device_step``): features, on
        an uninitialised map with ``bootstrap`` a bootstrap attempt, and
        ``_device_step``.  Returns (feats, cam_active, TrackResult, scalars,
        the frame's TrackerTiming or None)."""
        fid = self.frame_count
        at = timing.mark()
        with span("system.device_step", fid):
            images = torch.as_tensor(images).to(self.device, torch.float32)
            cam_active = self._cam_active(cam_active)
            with span("frontend.features", fid):
                feats = self._features(images)
            if bootstrap and not self.initialized:
                # request-init: the first frame bootstraps the map; init
                # fails with too few points (src/MapMakerServerBase.cc:146-261)
                # and is retried on the next frame
                self.ms, ok = self.mapmaker.init(self.ms, feats, self.ts.pose)
                if ok:
                    self.initialized = True
                    self.mapmaker.on_map_changed()
            self.ts, self.ms, res, scalars = self._device_step(
                self.ts, self.ms, feats, cam_active, self._queue_poses(), fid)
        self.frame_count += 1
        return feats, cam_active, res, scalars, frame_timings(timing.since(at)).get(fid)

    def _queue_poses(self):
        """Queued-MKF poses and depths in the static distance slots; the
        all-empty constant serves the common empty-queue frame."""
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

    # -- the live session ----------------------------------------------------
    def process_frame(self, images, cam_active=None) -> FrameInfo:
        """Track one frame: images (C,H,W) uint8 or float.  cam_active: (C,)
        bool, the cameras that delivered this frame (dropouts are tolerated,
        src/Tracker.cc:286-316).  Returns the FrameInfo of the frame that
        drained, or the newest frame's provisional one while the pipeline
        primes."""
        fid = self.frame_count
        feats, cam_active, res, scalars, tt = self._frame_step(images, cam_active,
                                                              bootstrap=True)
        host, ready = _to_host(scalars)
        self._inflight.append(_Frame(fid, host, ready, feats, res, cam_active, timing=tt))

        added_any = False
        if self._inflight_frames() > self.pipeline_depth:
            entry = self._inflight.popleft()
            if isinstance(entry, _Frame):
                info = self._drain_frame(entry, do_actions=True)
            else:
                # a batch queued by process_frames drains here: its older
                # frames ride on the newest one's info, in order
                infos = self._drain_batch(entry, do_actions=True)
                info = infos[-1]
                info.siblings = infos[:-1]
                added_any = any(i.added_mkf for i in infos)
        else:
            # pipeline priming: publish the newest frame; it runs its
            # control actions when it drains
            info = self._drain_frame(self._inflight[-1], do_actions=False)
            info.provisional = True

        budget = self.mcfg.duty_budget_ms
        self.ms = self.mapmaker.step(self.ms, budget_s=budget * 1e-3 if budget > 0 else None)
        if info.added_mkf or added_any:
            self.mapmaker.on_map_changed()
        if self.mapmaker.reset_requested:
            self._reset_after_failed_ba()
        info.mm_state = self.mapmaker.state
        return info

    def _frame_info(self, r: np.ndarray, fid: int, tt: TrackerTiming = None) -> FrameInfo:
        """A FrameInfo from one packed scalar row and the frame's timing."""
        pose34 = np.concatenate([r[6:15].reshape(3, 3), r[15:18][:, None]], 1)
        cov = r[18:54].reshape(6, 6)
        tt = dataclasses.replace(tt or TrackerTiming(), map_num_points=int(r[4]),
                                 map_num_mkfs=int(r[5]))
        return FrameInfo(
            pose=pose34, cov=publish_pose_cov(pose34, cov, int(r[1])),
            cov_raw=cov, quality=int(r[1]), lost=bool(r[0]), relocalized=False,
            n_points=int(r[4]), n_mkfs=int(r[5]), n_found=int(r[3]),
            mm_state=self.mapmaker.state, timing=tt, added_mkf=False,
            frame_id=fid)

    def _relocalize(self, pose: SE3):
        """Seat the tracker at a recovered pose, motion model cleared."""
        self.ts = dataclasses.replace(
            self.ts, pose=pose, vel=torch.zeros(6, device=self.device),
            lost_count=torch.zeros((), dtype=torch.int32, device=self.device))

    def _drain_frame(self, entry: _Frame, do_actions: bool) -> FrameInfo:
        """Unpack one frame's scalar row and, when it drains for real, run
        its control actions: relocalisation when lost, the keyframe add
        (candidates pruned by the MiniPatch stability filter against the
        previous frame, ref MakeKeyFrame_Rest, src/KeyFrame.cc:456-529)."""
        with span("system.drain_wait", entry.fid):
            timing.wait(entry.ready)
        v = entry.scalars.numpy()
        info = self._frame_info(v, entry.fid, entry.timing)
        if do_actions:
            if (info.lost and entry.fid >= self._reloc_done_fid
                    and not self._newer_frame_recovered()):
                pose, ok, _ = self._reloc_fn(self.ms, entry.feats, entry.cam_active)
                if bool(ok):
                    self._relocalize(pose)
                    info.relocalized = True
                    self._reloc_done_fid = self.frame_count
            # the add heuristic's verdict (quality, lost and distance folded
            # in on the device), or a pending ManualAddMKF; the reference
            # refuses adds only with more than 2 MKFs queued
            # (src/MapMakerClientBase.cc:113)
            force_add = self._force_add_next and not info.lost
            if ((self.vars["AddingMKFs"] and bool(v[2])) or force_add) \
                    and self.mapmaker.queue_size() <= 2:
                self._force_add_next = False
                mk_feats = entry.feats
                if self._prev_feats is not None:
                    mk_feats = filter_frame_candidates(self._prev_feats, entry.feats)
                self.mapmaker.add_mkf(mk_feats, entry.result.pose, entry.result,
                                      cam_active=entry.cam_active)
                info.added_mkf = True
            self._prev_feats = entry.feats
            self._last_result = entry.result
        return info

    # -- the throughput mode -------------------------------------------------
    def _batch_step(self, ts, ms, images_b, cam_active, queue_poses=None):
        """The B-frame step: a loop over frames carrying (ts, ms), the
        frames numbered from ``frame_count``.  Returns (ts, ms, (B,54)
        scalars, per-frame TrackResults)."""
        if queue_poses is None:
            queue_poses = self._empty_queue_poses
        fid0 = self.frame_count
        rows, results = [], []
        with span("system.batch_step", fid0):
            for j, images in enumerate(images_b):
                with span("frontend.features", fid0 + j):
                    feats = self._features(images)
                ts, ms, res, scalars = self._device_step(ts, ms, feats, cam_active,
                                                         queue_poses, fid0 + j)
                rows.append(scalars)
                results.append(res)
        return ts, ms, torch.stack(rows), results

    def process_frames(self, images_batch, cam_active=None) -> list:
        """Throughput mode: track B consecutive frames (B,C,H,W) uint8 or
        float in one step.  Returns the FrameInfos drained by this call, in
        frame order (possibly none while the pipeline primes).  An
        uninitialised system takes the frames one by one through
        process_frame, which bootstraps the map."""
        images_batch = torch.as_tensor(images_batch).to(self.device)
        B = int(images_batch.shape[0])
        if not self.initialized:
            return [self.process_frame(images_batch[i], cam_active) for i in range(B)]
        cam_active = self._cam_active(cam_active)
        at = timing.mark()
        self.ts, self.ms, scal, results = self._batch_step(
            self.ts, self.ms, images_batch, cam_active, self._queue_poses())
        host, ready = _to_host(scal)
        self._inflight.append(_Batch(self.frame_count, host, ready, B, images_batch,
                                     results, cam_active, frame_timings(timing.since(at))))
        self.frame_count += B

        out = []
        while self._inflight and self._inflight_frames() > self.pipeline_depth:
            out.extend(self._drain(self._inflight.popleft()))

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

    def _drain(self, entry) -> list:
        """Drain one in-flight entry of either kind, with its actions."""
        if isinstance(entry, _Frame):
            return [self._drain_frame(entry, do_actions=True)]
        return self._drain_batch(entry, do_actions=True)

    def _drain_batch(self, entry: _Batch, do_actions: bool) -> list:
        """Unpack one drained batch into FrameInfos and run its control
        actions: relocalisation when its newest frame is lost, and at most
        one keyframe add, the newest qualifying frame (features recomputed,
        pose and tracker measurements from its TrackResult)."""
        with span("system.drain_wait", entry.fid0):
            timing.wait(entry.ready)
        v = entry.scalars.numpy()
        tts = entry.timings or {}
        infos = [self._frame_info(v[j], entry.fid0 + j, tts.get(entry.fid0 + j))
                 for j in range(v.shape[0])]
        if not do_actions:
            return infos
        last = infos[-1]
        if (last.lost and last.frame_id >= self._reloc_done_fid
                and not self._newer_frame_recovered()):
            feats = self._features(entry.images[-1].to(torch.float32))
            pose, ok, _ = self._reloc_fn(self.ms, feats, entry.cam_active)
            if bool(ok):
                self._relocalize(pose)
                last.relocalized = True
                self._reloc_done_fid = self.frame_count
        force_add = self._force_add_next and not last.lost
        want = [j for j, i in enumerate(infos) if bool(v[j][2]) and not i.lost]
        if ((self.vars["AddingMKFs"] and want) or force_add) \
                and self.mapmaker.queue_size() <= 2:
            j = want[-1] if want else len(infos) - 1
            self._force_add_next = False
            feats = self._features(entry.images[j].to(torch.float32))
            res = entry.results[j]
            self.mapmaker.add_mkf(feats, res.pose, res, cam_active=entry.cam_active)
            infos[j].added_mkf = True
        return infos

    # -- pipeline bookkeeping ------------------------------------------------
    def flush_pipeline(self) -> list:
        """Drain every in-flight frame, in order, then integrate every MKF
        still queued, so that a map saved right after has its last MKF."""
        out = []
        while self._inflight:
            out.extend(self._drain(self._inflight.popleft()))
        if any(i.added_mkf for i in out):
            self.mapmaker.on_map_changed()
        while self.mapmaker.queue:
            self.ms = self.mapmaker.step(self.ms)
        return out

    def _inflight_frames(self) -> int:
        return sum(e.n for e in self._inflight)

    def _newer_frame_recovered(self) -> bool:
        """True when an in-flight frame whose scalars have already landed
        reports not-lost: the tracker recovered on its own, and
        relocalising on a stale lost flag would overwrite that pose.
        Never blocks the pipeline."""
        for e in self._inflight:
            if e.ready is None or e.ready.query():
                if bool(np.any(e.scalars.reshape(-1, N_SCALARS)[:, 0].numpy() < 0.5)):
                    return True
        return False

    def _reset_after_failed_ba(self):
        """Repeated BA failure: dump the failed map (ref fail_map.dat,
        src/MapMakerBase.cc:143-148), then a full reset at the same pose."""
        if self.mcfg.fail_dump_path:
            dump_map_ascii(self.mcfg.fail_dump_path, self.ms)
        self.reset(keep_pose=True)

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
        self._reloc_done_fid = -1

    # -- checkpoint / resume -------------------------------------------------
    def save(self, path: str):
        """Checkpoint the session: the map, the tracker pose and the
        scheduler state, in the JAX package's npz layout."""
        save_map(path, self.ms, extras={
            "pose_R": self.ts.pose.R, "pose_t": self.ts.pose.t,
            "mm_state": np.int32(self.mapmaker.state),
            "initialized": np.bool_(self.initialized),
        })

    def load(self, path: str):
        """Resume a checkpoint: the map restored, the tracker re-seated at
        the saved pose, the map-maker's schedule resumed.  Capacities must
        match this System's."""
        ms, extras = load_map(path, self.ms, with_extras=True)
        self.ms = ms
        self.ts = create_tracker_state(self.n_cams, self.device)
        self.ts.pose = SE3(
            R=torch.as_tensor(extras["pose_R"]).to(self.device, torch.float32),
            t=torch.as_tensor(extras["pose_t"]).to(self.device, torch.float32))
        self.initialized = bool(extras["initialized"])
        self.mapmaker.reset(self.ms)
        self.mapmaker.state = int(extras["mm_state"])
        self.mapmaker.on_map_changed()
        # a restore starts clean: the previous session's frames must not
        # feed the candidate filter or the monitor image
        self._prev_feats = None
        self._last_result = None
        self._force_add_next = False
        self.done = False
        self._kf_view = 0
        self._inflight.clear()

    # -- staged profiling (the TrackerTiming taxonomy) ------------------------
    def profile_frame(self, images, cam_active=None) -> TrackerTiming:
        """Track one frame under the tracer's synchronous mode, each stage
        ended by a device synchronise, and return the reference's
        TrackerTiming taxonomy from its spans (msg/TrackerTiming.msg,
        src/Tracker.cc:293-332): features, sbi, motion, pvs, coarse, fine,
        pose, depth (scene depth, quality, state update) and add (point
        statistics and the add heuristic).  The tracker and map state change
        as in process_frame's device step; the map-maker does not tick and
        no keyframe is added."""
        prev = timing.enable(True, sync=True)
        try:
            feats, _, res, _, tt = self._frame_step(images, cam_active, bootstrap=False)
        finally:
            timing.enable(*prev)
        self._prev_feats = feats
        self._last_result = res
        return tt

    # -- the GUI console and the viewers (ref src/System.cc:305-405) -----------
    def parse_line(self, line: str):
        """GVars3 ``GUI.ParseLine`` analogue: one command string.  The
        reference's vocabulary (src/System.cc:64-77): quit/exit, Reset,
        InitTracker, ShowNextKeyFrame, ShowPrevKeyFrame, ScaleMapUp,
        ScaleMapDown, ExportMapToFile [map.dat [cameras.dat]],
        ManualAddMKF, KeyPress <k>; and ``Name=Value`` assignments to the
        runtime variables."""
        line = line.strip()
        if not line:
            return
        if "=" in line and " " not in line.split("=", 1)[0]:
            name, value = (x.strip() for x in line.split("=", 1))
            if name not in self.vars:
                raise KeyError(f"unknown var {name!r}; have {sorted(self.vars)}")
            cur = self.vars[name]
            if isinstance(cur, bool):
                value = value.lower() in ("1", "true", "yes", "on")
            elif isinstance(cur, int):
                value = int(value)
            elif isinstance(cur, float):
                value = float(value)
            self.set_var(name, value)
            return
        cmd, *params = line.split()
        if cmd in ("quit", "exit"):
            self.done = True
        elif cmd == "Reset":
            self.reset()
        elif cmd == "InitTracker":
            # the reference's RequestInit only matters before a map exists
            # (src/Tracker.cc:625-631); here the map bootstraps on its own
            pass
        elif cmd == "ShowNextKeyFrame":
            self._kf_view += 1
        elif cmd == "ShowPrevKeyFrame":
            self._kf_view -= 1
        elif cmd == "ScaleMapUp":
            self.rescale_map(2.0)
        elif cmd == "ScaleMapDown":
            self.rescale_map(0.5)
        elif cmd == "ExportMapToFile":
            dump_map_ascii(params[0] if params else "map.dat", self.ms)
            dump_cameras_ascii(params[1] if len(params) > 1 else "cameras.dat",
                               self.cams, self.cam_from_base, self.H, self.W)
        elif cmd == "ManualAddMKF":
            self.manual_add_mkf()
        elif cmd == "KeyPress":
            key = params[0] if params else ""
            if key == "r":
                self.reset()
            elif key in ("q", "Escape"):
                self.done = True
            elif key == "o":
                self.mapmaker.on_map_changed()  # SetNotConverged analogue
            elif key == "a":
                self.parse_line("ManualAddMKF")
            elif key == "Space":
                self.parse_line("InitTracker")
        else:
            raise ValueError(f"unhandled GUI command: {cmd!r}")

    def small_image(self, level: int | None = None):
        """Tiled monitor image of the last drained frame with its found
        measurements (ref PublishSmallImage) -> (H,W,3) uint8, or None
        before the first frame."""
        if self._prev_feats is None:
            return None
        return frame_small_image(self._prev_feats, self._last_result,
                                 self.vars["DrawLevel"] if level is None else level)

    def keyframe_view(self, cam_idx: int = 0):
        """The KeyFrameViewer's image: the measurement overlay of the MKF
        under the cursor (ref KeyFrameViewer.h:57-89) -> (H,W,3) uint8, or
        None when the map has no keyframe."""
        valid = np.nonzero(self.ms.mkfs.valid.cpu().numpy())[0]
        if valid.size == 0:
            return None
        return keyframe_overlay(self.ms, int(valid[self._kf_view % valid.size]), cam_idx)

    # -- map commands ----------------------------------------------------------
    def rescale_map(self, scale: float):
        """Uniform global map rescale (the Rescale command); the tracker's
        pose scales with it."""
        self.ms = apply_global_scale(self.ms, scale)
        self.ts.pose = SE3(R=self.ts.pose.R, t=self.ts.pose.t * scale)
        self.mapmaker.on_map_changed()

    def align_to_dominant_plane(self, seed: int = 0) -> bool:
        """Re-express the world with the dominant plane of the live points at
        z = 0 (CalcPlaneAligner + ApplyGlobalTransformationToMap); the
        RANSAC's triples come from a generator seeded with ``seed``.
        Returns whether a plane was found; without one nothing changes."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        pts = self.ms.points
        Tn, ok = plane_align_transform(pts.pos_w, pts.valid & ~pts.bad, gen)
        if not bool(ok):
            return False
        self.ms = apply_global_transform(self.ms, Tn)
        # the tracker's pose lives in world coordinates:
        # base_from_world' = base_from_world @ T^-1
        self.ts.pose = self.ts.pose @ Tn.inv()
        self.mapmaker.on_map_changed()
        return True
