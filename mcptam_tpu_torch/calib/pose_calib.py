"""Pose-calibrator tracking phase: TrackerCalib and MapMakerCalib (port of
mcptam_tpu/calib/pose_calib.py).

The reference calibrates rig extrinsics WITHOUT requiring simultaneous
board views: each camera bootstraps its own metric pose from the
checkerboard whenever it sees it, then tracks a shared board-anchored
map; keyframes dropped while tracking are optimised as INDEPENDENT poses
in the background, and the relative-pose observable comes from cameras
tracking the map at the same instant (src/PoseCalibrator.cc:221-411,
src/TrackerCalib.cc:248-420, src/MapMakerCalib.cc:72-226,248-528,
src/BundleAdjusterSingle.cc:55-120).

  * the shared map is a standard MapState whose extrinsics are ALL
    identity: one MKF per dropped keyframe with ``kf_valid`` masking the
    single owning camera, so each MKF base IS an independent
    camera-from-world and the stock bundle over the map (``problem_single``)
    reproduces BundleAdjusterSingle's layout;
  * per-camera tracking reuses the rig tracker with ``cam_active`` one-hot
    (TrackerCalib runs one Tracker per camera);
  * cameras GOOD at the same frame form a *sync group*, the analogue of
    the reference assembling simultaneously dropped keyframes into one
    MultiKeyFrame (TransferKeyFrame, src/PoseCalibrator.cc:474-500);
  * CalibInit = a final global BA, then geodesic-L2 rotation averaging of
    per-group relative poses (FindAverageRelativePoses,
    src/MapMakerCalib.cc:248-345), then a per-group base-shift
    Gauss-Newton (src/MapMakerCalib.cc:398-488), then the Calib-layout
    bundle with shared movable extrinsics (BundleAdjusterCalib).

Each frame runs the port's kernels through the calls it makes: the FAST
front-end and the half-sample pyramid (``make_frame_features``), the fused
patch search and ESM (``track_frame``), the window gather
(``integrate_mkf``) and the Cholesky solve of the bundles'
reduced systems (``lm_run``, routed by ``core/spd.route``).  The session
reads each tracked camera's quality and loss, and an integration's
acceptance, back to the host: they steer the reference's control flow.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from mcptam_tpu_torch.ba.adjusters import apply_outliers, problem_single, writeback
from mcptam_tpu_torch.ba.bundle import (
    BundleProblem, attach_obs_table, create_lm_state, lm_run, tukey_outlier_pass,
)
from mcptam_tpu_torch.calib.extrinsic import average_relative_poses, board_pose_pnp
from mcptam_tpu_torch.config import BundleConfig, MapMakerConfig, TrackerConfig
from mcptam_tpu_torch.core.camera import CameraModel
from mcptam_tpu_torch.core.se3 import SE3, so3_exp, so3_ln
from mcptam_tpu_torch.map.builder import add_measurements, add_points, commit_mkf
from mcptam_tpu_torch.map.keyframe import FrameFeatures, make_frame_features
from mcptam_tpu_torch.map.mapmaker_core import integrate_mkf
from mcptam_tpu_torch.map.state import (
    SRC_ROOT, MapState, create_map_state, kf_cam_from_world,
    refresh_scene_depths,
)
from mcptam_tpu_torch.tracker.tracker import (
    QUALITY_GOOD, create_tracker_state, track_frame,
)

# effective "level" of direct grid-corner detections in the FINAL calib
# bundle: residual sigma = 2^level px, so -2 = 0.25 px detector sigma.
# Applied only when the calib problem is extracted: inside the live map
# the adaptive-Huber sigma is a median over mixed sources, which a 16x
# chi2 rescale of the detections would poison.
DETECTION_LEVEL = -2


def init_from_calib_image(ms: MapState, cams: CameraModel,
                          feats: FrameFeatures, cam: int,
                          corner_uv, board_xy, pose_c: SE3,
                          return_slots: bool = False):
    """Bootstrap the calibration map from one camera's board view
    (InitFromCalibImage, src/MapMakerCalib.cc:72-226): one single-camera
    MKF at the board-PnP pose, FIXED points at the metric grid corners
    (z = 0 board plane), ROOT measurements at the detected corners.

    corner_uv (K,2): detected corner image positions; board_xy (K,2):
    matching metric board coordinates.  Updates ms in place; returns
    (ms, mkf_idx) or, with return_slots, (ms, mkf_idx, point slots)."""
    dev = ms.mkfs.valid.device
    C = ms.cam_from_base.t.shape[0]
    kf_valid = torch.zeros(C, dtype=torch.bool, device=dev)
    kf_valid[cam] = True
    ms, mkf_idx, _ = commit_mkf(ms, feats, pose_c, kf_valid=kf_valid)
    K = len(corner_uv)
    board = torch.as_tensor(np.asarray(board_xy), dtype=torch.float32, device=dev)
    pos_w = torch.cat([board, torch.zeros((K, 1), device=dev)], 1)
    ms, slots, _ = add_points(
        ms, cams, mkf_idx=mkf_idx,
        cam_idx=torch.full((K,), cam, dtype=torch.int32, device=dev),
        level=torch.zeros(K, dtype=torch.int32, device=dev),
        xy_level=torch.as_tensor(np.asarray(corner_uv), dtype=torch.float32, device=dev),
        pos_w=pos_w, want=torch.ones(K, dtype=torch.bool, device=dev),
        fixed=torch.ones(K, dtype=torch.bool, device=dev),
    )
    ms = refresh_scene_depths(ms)
    if return_slots:
        return ms, mkf_idx, slots
    return ms, mkf_idx


def need_new_kf(ms: MapState, cam: int, pose_c: SE3, mean_depth,
                max_scaled_dist: float):
    """Per-camera add heuristic: depth-scaled distance from the tracked
    camera pose to the closest keyframe OWNED BY THE SAME CAMERA
    (NeedNewKeyFrame with bSameCamName=true,
    src/MapMakerClientBase.cc:181-211 via TrackerCalib,
    src/TrackerCalib.cc:315-325).  Returns a () bool tensor."""
    frac = 0.5
    inv = kf_cam_from_world(ms).inv()
    pos = inv.t                                               # (M,C,3)
    depth = ms.mkfs.scene_depth_mean
    z = torch.zeros_like(depth)
    dpt = inv.apply(torch.stack([z, z, depth], -1))
    my_inv = pose_c.inv()
    zero = torch.zeros((), dtype=depth.dtype, device=depth.device)
    my_dpt = my_inv.apply(torch.stack([zero, zero, torch.as_tensor(
        mean_depth, dtype=depth.dtype, device=depth.device)]))
    d = (torch.linalg.vector_norm(pos - my_inv.t, dim=-1)
         + frac * torch.linalg.vector_norm(dpt - my_dpt, dim=-1))
    C = ms.cam_from_base.t.shape[0]
    ok = ms.mkfs.valid[:, None] & ms.mkfs.kf_valid
    ok = ok & (torch.arange(C, device=d.device)[None, :] == cam)
    d = torch.where(ok, d, torch.full_like(d, float("inf")))
    scaled = torch.min(d) / torch.clamp(torch.as_tensor(mean_depth, device=d.device),
                                        min=1e-6)
    return scaled > max_scaled_dist


def _one_hot(C: int, c: int, device) -> torch.Tensor:
    ca = torch.zeros(C, dtype=torch.bool, device=device)
    ca[c] = True
    return ca


@dataclass
class PoseCalibSession:
    """Per-camera board bootstrap, shared-map tracking and background
    single-pose BA, then the final extrinsic solve.

    Feed :meth:`process_frame` synchronised (C,H,W) frames and the
    per-camera board detections (uv, board_idx into board_pts2) the
    caller found (the app: from calib.corners); a camera joins tracking
    as soon as it has one accepted board PnP.  Everything lives on the
    cameras' device."""

    cams: CameraModel
    cams_sbi: CameraModel
    params9: list                      # per-camera 9-vector (PnP bootstrap)
    board_pts2: np.ndarray             # (K,2) metric board corner coords
    H: int
    W: int
    max_points: int = 2048
    max_mkfs: int = 24
    max_meas: int = 8192
    tcfg: TrackerConfig = field(default_factory=TrackerConfig)
    mcfg: MapMakerConfig = field(default_factory=MapMakerConfig)
    bcfg: BundleConfig = field(default_factory=BundleConfig)
    max_scaled_kf_dist: float = 0.1
    ba_chunk: int = 10

    def __post_init__(self):
        self.device = self.cams.center.device
        C = int(self.cams.theta_mean.shape[0])
        self.C = C
        self.ms = create_map_state(
            self.H, self.W, C, SE3.identity((C,), device=self.device),
            self.max_points, self.max_mkfs, self.max_meas)
        self.trackers = [create_tracker_state(C, device=self.device) for _ in range(C)]
        self.running = [False] * C
        self._bad_streak = [0] * C
        self.map_good = False
        self.sync_groups: list = []    # list[dict cam -> mkf slot]
        self.frame_count = 0
        self._ba_prob = None
        self._ba_state = None
        self._ba_steps = 0
        # final-phase results
        self.cam_from_base = None      # SE3 (C,) after calib_init/calib_step
        self.group_bases = None

    def _track(self, ts, feats, ca):
        return track_frame(ts, self.ms, self.cams, self.cams_sbi, feats, self.tcfg,
                           cam_active=ca)

    # -- per-frame ---------------------------------------------------------
    @staticmethod
    def _as_candidates(det):
        """A detection entry is one (uv, board_idx) labelling or a list of
        candidate labellings (a symmetric checkerboard has a 180-degree
        twin the detector cannot resolve)."""
        if isinstance(det, list):
            return det
        return [det]

    def _pnp_candidates(self, c: int, det):
        """Board PnP of every candidate labelling of camera c's detection:
        a list of (pose_c SE3, uv, bidx)."""
        out = []
        for uv, bidx in self._as_candidates(det):
            if len(uv) < 8:
                continue
            res = board_pose_pnp(self.params9[c], self.board_pts2[bidx],
                                 np.asarray(uv), (self.W, self.H))
            if res is None:
                continue
            R, t = res
            out.append((SE3(R=torch.as_tensor(R, dtype=torch.float32, device=self.device),
                            t=torch.as_tensor(t, dtype=torch.float32, device=self.device)),
                        np.asarray(uv), np.asarray(bidx)))
        return out

    def _arbitrate_twin(self, c: int, feats, cands_c):
        """The shared map arbitrates a symmetric board's 180-degree twin:
        one tracking pass against the map from each candidate PnP pose;
        only the labelling consistent with the map's board frame finds
        measurements.  (The app's cross-view consensus needs simultaneous
        views, which zero-overlap rigs never have; a TrackerCalib
        bootstrapped on the wrong twin loses tracking and re-bootstraps,
        src/TrackerCalib.cc:248-420.)  Returns the winner, or None when
        ambiguous (the caller waits for a later view)."""
        if len(cands_c) == 1:
            return cands_c[0]
        ca = _one_hot(self.C, c, self.device)
        # score only non-fixed (scene) points: the fixed grid corners are
        # themselves 180-degree symmetric and match from both twin poses
        fixed = self.ms.points.fixed.cpu().numpy()
        scores = []
        for pose_c, _uv, _bidx in cands_c:
            probe = dataclasses.replace(
                create_tracker_state(self.C, device=self.device), pose=pose_c)
            _, res = self._track(probe, feats, ca)
            sel = res.sel_point.cpu().numpy()
            fnd = res.sel_found.cpu().numpy()
            scores.append(int(np.sum(fnd & ~fixed[sel])))
        order = sorted(range(len(scores)), key=lambda i: -scores[i])
        best, second = order[0], order[1]
        if scores[best] >= 8 and scores[best] >= 2 * max(scores[second], 1):
            return cands_c[best]
        return None

    def _consistent_labeling(self, c: int, pose_tracked: SE3, cands_c,
                             max_rot: float = 0.5):
        """Among candidate labellings, the one whose PnP pose agrees with
        the tracked pose (keeps one camera's twin choice consistent across
        its frames); None if nothing is close."""
        best, best_d = None, np.inf
        for cand in cands_c:
            d = float(np.linalg.norm(
                (cand[0] @ pose_tracked.inv()).ln().cpu().numpy().astype(np.float64)[3:]))
            if d < best_d:
                best, best_d = cand, d
        if best is not None and best_d < max_rot:
            return best
        return None

    def process_frame(self, images, detections=None):
        """One synchronised frame (C,H,W).  detections: optional dict
        cam -> (uv (N,2), board_idx (N,)), or a LIST of such candidate
        labellings when the detector could not resolve the board's
        180-degree twin, of board corners found in that camera's image."""
        detections = detections or {}
        if not isinstance(images, torch.Tensor):
            images = torch.tensor(np.asarray(images))
        feats = make_frame_features(images.to(self.device, torch.float32))
        self.frame_count += 1

        # 1. board bootstrap of cameras not yet running (TrackerCalib's
        #    CHECKERBOARD stages, src/TrackerCalib.cc:345-390)
        for c in range(self.C):
            if self.running[c] or c not in detections:
                continue
            cands_c = self._pnp_candidates(c, detections[c])
            if not cands_c:
                continue
            if self.map_good:
                cand = self._arbitrate_twin(c, feats, cands_c)
                if cand is None:
                    continue
                pose_c, uv, bidx = cand
            else:
                # first camera: either twin is a valid gauge choice
                pose_c, uv, bidx = cands_c[0]
                self.ms, init_idx, slots = init_from_calib_image(
                    self.ms, self.cams, feats, c, np.asarray(uv),
                    self.board_pts2[bidx], pose_c, return_slots=True)
                self._board_slot = np.full(len(self.board_pts2), -1, np.int32)
                self._board_slot[np.asarray(bidx)] = slots.cpu().numpy()
                self.map_good = True
                # the init MKF is a keyframe of camera c like any other: its
                # FIXED board measurements pin the gauge of the final Calib
                # bundle (RemoveMultiKeyFrames(firstCam, true),
                # src/MapMakerCalib.cc:229-245,372-376)
                self.sync_groups.append({c: int(init_idx)})
            self.trackers[c] = dataclasses.replace(
                self.trackers[c], pose=pose_c,
                vel=torch.zeros(6, device=self.device),
                lost_count=torch.zeros((), dtype=torch.int32, device=self.device))
            self.running[c] = True

        if not self.map_good:
            return

        # 2. per-camera tracking against the shared map
        results, good = {}, {}
        for c in range(self.C):
            if not self.running[c]:
                continue
            self.trackers[c], res = self._track(self.trackers[c], feats,
                                                _one_hot(self.C, c, self.device))
            results[c] = res
            good[c] = int(res.quality) == QUALITY_GOOD and not bool(res.lost)
            # persistent loss sends the camera back to the checkerboard
            # stage (src/TrackerCalib.cc:289-343); this also corrects a
            # bootstrap on the wrong twin of a symmetric board
            if not good[c]:
                self._bad_streak[c] += 1
                if self._bad_streak[c] >= 5:
                    self.running[c] = False
                    self._bad_streak[c] = 0
            else:
                self._bad_streak[c] = 0

        # 3. drop keyframes: when ANY running camera signals a drop (its
        #    distance heuristic fires, or it has no keyframe yet), EVERY
        #    GOOD running camera contributes a single-camera MKF, as the
        #    reference gathers every calibrated GOOD tracker into one
        #    MultiKeyFrame (src/PoseCalibrator.cc:285-345).  Simultaneous
        #    contributions form a sync group: the relative-pose observable.
        need_drop = False
        for c, res in results.items():
            if not good[c]:
                continue
            # a board-detection frame always drops: a detected grid is the
            # most precise observation the session gets for the camera
            # (the reference consumes every detection in
            # CHECKERBOARD_SECOND_STAGE, src/TrackerCalib.cc:263-283)
            if c in detections:
                need_drop = True
                continue
            depth_c = torch.clamp(res.mean_depth[c], min=1e-3)
            has_kf = bool(torch.any(self.ms.mkfs.valid & self.ms.mkfs.kf_valid[:, c]))
            if (not has_kf) or bool(need_new_kf(self.ms, c, res.pose, depth_c,
                                                self.max_scaled_kf_dist)):
                need_drop = True
        group = {}
        if need_drop:
            for c, res in results.items():
                if not good[c]:
                    continue
                self.ms, mkf_idx, accepted = integrate_mkf(
                    self.ms, self.cams, feats, res.pose, res, self.mcfg,
                    cam_active=_one_hot(self.C, c, self.device))
                if accepted:
                    slot = int(mkf_idx)
                    group[c] = slot
                    if c in detections:
                        # the board was detected in this very frame: the
                        # detected corners become direct measurements of
                        # the FIXED grid points (CHECKERBOARD_SECOND_STAGE,
                        # src/TrackerCalib.cc:263-283), with the labelling
                        # consistent with the tracked pose (a symmetric
                        # board's twin would flip the correspondences)
                        cand = self._consistent_labeling(
                            c, res.pose, self._pnp_candidates(c, detections[c]))
                        if cand is not None:
                            self._record_board_measurements(slot, c, cand[1], cand[2])
            if group:
                # every drop group is an MKF analogue: singletons still
                # carry measurements into the final Calib bundle; only
                # groups with >= 2 cameras give relative-pose samples
                self.sync_groups.append(group)
                self._abort_ba(apply_partial=True)

        # 4. background single-pose BA, one preemptible chunk a frame
        #    (MapMaker::run with BundleAdjusterSingle)
        self._ba_tick()

    def _record_board_measurements(self, mkf_idx: int, cam: int, uv, bidx):
        """Detected grid corners -> measurements of the FIXED board points
        in a freshly dropped KF, skipping pairs the tracker recorded."""
        slots = self._board_slot[np.asarray(bidx)]
        keep = slots >= 0
        if not keep.any():
            return
        dev = self.device
        slots_t = torch.as_tensor(np.maximum(slots, 0), dtype=torch.int32, device=dev)
        K = slots_t.shape[0]
        meas = self.ms.meas
        dup = meas.valid & (meas.mkf == mkf_idx) & (meas.cam == cam)
        exists = torch.zeros(self.ms.points.capacity, dtype=torch.int32, device=dev)
        exists = exists.scatter_reduce(0, meas.point.long(), dup.to(torch.int32),
                                       reduce="amax") > 0
        want = torch.as_tensor(keep, device=dev) & ~exists[slots_t.long()]
        self.ms = add_measurements(
            self.ms,
            mkf=torch.full((K,), mkf_idx, dtype=torch.int32, device=dev),
            cam=torch.full((K,), cam, dtype=torch.int32, device=dev),
            point=slots_t, level=torch.zeros(K, dtype=torch.int32, device=dev),
            uv_l0=torch.as_tensor(np.asarray(uv), dtype=torch.float32, device=dev),
            want=want,
            source=torch.full((K,), SRC_ROOT, dtype=torch.int32, device=dev),
            subpix=torch.ones(K, dtype=torch.bool, device=dev),
        )

    # -- background BA -----------------------------------------------------
    def _abort_ba(self, apply_partial: bool):
        if (self._ba_state is not None and apply_partial
                and int(self._ba_state.accepted) > 0):
            self.ms = writeback(self.ms, self._ba_prob, self._ba_state)
        self._ba_prob = None
        self._ba_state = None
        self._ba_steps = 0

    def _ba_tick(self):
        if self._ba_state is None:
            self._ba_prob = attach_obs_table(problem_single(self.ms), self.bcfg.obs_cap)
            self._ba_state = create_lm_state(self._ba_prob, self.bcfg)
            self._ba_steps = 0
        self._ba_state = lm_run(self._ba_prob, self._ba_state, self.cams,
                                self.ba_chunk, self.bcfg)
        self._ba_steps += self.ba_chunk
        if (bool(self._ba_state.converged)
                or self._ba_steps >= self.bcfg.max_iterations):
            if int(self._ba_state.accepted) > 0:
                self.ms = writeback(self.ms, self._ba_prob, self._ba_state)
            self._ba_prob = None
            self._ba_state = None

    # -- final optimisation --------------------------------------------------
    def calib_init(self, final_ba_steps: int = 60):
        """Final global BA, relative-pose averaging and the base-shift GN
        (MapMakerCalib::CalibInit, src/MapMakerCalib.cc:348-493).  Returns
        the initialised cam_from_base (C,) SE3."""
        self._abort_ba(apply_partial=True)
        prob = attach_obs_table(problem_single(self.ms), self.bcfg.obs_cap)
        st = lm_run(prob, create_lm_state(prob, self.bcfg), self.cams,
                    final_ba_steps, self.bcfg)
        self.ms = writeback(self.ms, prob, st)
        self.ms = apply_outliers(self.ms, tukey_outlier_pass(prob, st, self.cams))

        # the groups that contain camera 0 (RemoveMultiKeyFrames(firstCam,
        # true), src/MapMakerCalib.cc:372-380)
        groups = [g for g in self.sync_groups if 0 in g]
        if not any(len(g) == self.C for g in groups):
            raise ValueError(
                "no sync group contains every camera — cameras never "
                "tracked simultaneously; record more frames")
        base_R = self.ms.mkfs.base_from_world.R.cpu().numpy()
        base_t = self.ms.mkfs.base_from_world.t.cpu().numpy()

        def pose_of(slot):
            return base_R[slot], base_t[slot]

        # per-camera relative pose samples T_c T_0^-1 across groups
        # (FindAverageRelativePoses, src/MapMakerCalib.cc:248-345)
        rel = [(np.eye(3), np.zeros(3))]
        for c in range(1, self.C):
            samples = []
            for g in groups:
                if c not in g:
                    continue
                R0, t0 = pose_of(g[0])
                Rc, tc = pose_of(g[c])
                Rr = Rc @ R0.T
                samples.append((Rr, tc - Rr @ t0))
            if not samples:
                raise ValueError(f"camera {c} never tracked simultaneously with camera 0")
            rel.append(average_relative_poses(samples, device=self.device))

        # per-group base-shift GN redistributing the pose error
        # (src/MapMakerCalib.cc:398-488)
        group_bases = []
        for g in groups:
            R0, t0 = pose_of(g[0])
            cfb = {}
            for c, slot in g.items():
                Rc, tc = pose_of(slot)
                Rr = Rc @ R0.T
                cfb[c] = (Rr, tc - Rr @ t0)   # KF cam-from-base, base = cam 0
            Rs, ts = _base_shift_gn(cfb, rel)
            Rsi, tsi = Rs.T, -Rs.T @ ts       # new base pose: shift^-1 T_0
            group_bases.append((Rsi @ R0, Rsi @ t0 + tsi))

        def f32(a):
            return torch.as_tensor(np.stack(a), dtype=torch.float32, device=self.device)

        self.groups = groups
        self.group_bases = SE3(R=f32([b[0] for b in group_bases]),
                               t=f32([b[1] for b in group_bases]))
        self.cam_from_base = SE3(R=f32([r[0] for r in rel]), t=f32([r[1] for r in rel]))
        return self.cam_from_base

    def calib_problem(self) -> BundleProblem:
        """Calib-layout bundle over the grouped map: pose_a = per-group base
        poses (movable: the fixed board points pin the gauge), pose_b = the
        shared cam-from-base extrinsics (camera 0 fixed = identity),
        measurements re-chained through their MKF's group
        (BundleAdjusterCalib, src/BundleAdjusterCalib.cc:88-308)."""
        ms = self.ms
        dev = self.device
        M = ms.mkfs.capacity
        G = len(self.groups)
        lut = np.full(M, -1, np.int32)            # MKF slot -> group (-1: none)
        for gi, g in enumerate(self.groups):
            for c, slot in g.items():
                lut[slot] = gi
        lut_t = torch.as_tensor(lut, device=dev)
        grp = lut_t[ms.meas.mkf.long()]
        pt = ms.meas.point.long()
        m_valid = (ms.meas.valid & (grp >= 0) & ms.points.valid[pt]
                   & ~ms.points.bad[pt])
        counts = torch.zeros(ms.points.capacity, dtype=torch.int32, device=dev)
        counts.index_add_(0, pt, m_valid.to(torch.int32))
        movable_pt = (ms.points.valid & ~ms.points.bad & ~ms.points.fixed
                      & (counts >= 2))
        movable_b = torch.ones(self.C, dtype=torch.bool, device=dev)
        movable_b[0] = False
        # direct grid detections (ROOT measurements of FIXED points) carry
        # detector precision, not patch-search precision
        detection = (ms.meas.source == SRC_ROOT) & ms.points.fixed[pt]
        return BundleProblem(
            pose_a=self.group_bases, pose_b=self.cam_from_base,
            movable_a=torch.ones(G, dtype=torch.bool, device=dev),
            movable_b=movable_b,
            points=ms.points.pos_w, movable_pt=movable_pt,
            m_pose_a=torch.clamp(grp, min=0), m_pose_b=ms.meas.cam,
            m_point=ms.meas.point, m_cam=ms.meas.cam, m_uv=ms.meas.uv_l0,
            m_level=torch.where(detection, torch.full_like(ms.meas.level, DETECTION_LEVEL),
                                ms.meas.level),
            m_valid=m_valid,
            pt_src_a=torch.clamp(lut_t[ms.points.src_mkf.long()], min=0),
            pt_src_b=ms.points.src_cam,
        )

    def calib_step(self, n_steps: int = 10):
        """LM steps of the Calib bundle (CalibOneStep,
        src/MapMakerCalib.cc:495-528).  Updates cam_from_base and
        group_bases; returns the LM state."""
        prob = attach_obs_table(self.calib_problem(), self.bcfg.obs_cap)
        st = lm_run(prob, create_lm_state(prob, self.bcfg), self.cams, n_steps, self.bcfg)
        self.cam_from_base = SE3(R=st.pose_b.R, t=st.pose_b.t)
        self.group_bases = SE3(R=st.pose_a.R, t=st.pose_a.t)
        return st


def _so3_f32(fn, x):
    """A float32 SO(3) map of the port evaluated on the host, in float64 out."""
    return fn(torch.as_tensor(x, dtype=torch.float32)).numpy().astype(np.float64)


def _base_shift_gn(cfb: dict, rel: list, iters: int = 10):
    """The reference's base-shift Gauss-Newton (src/MapMakerCalib.cc:398-488):
    the shift s minimising sum_c ||ln(cfb_c s rel_c^-1)||^2 with a unit
    prior, cfb_c the group's observed cam-from-base and rel_c the averaged
    extrinsic.  Host numpy: the problem is tiny."""
    def se3_mul(a, b):
        return a[0] @ b[0], a[0] @ b[1] + a[1]

    def se3_inv(a):
        return a[0].T, -a[0].T @ a[1]

    def se3_ln(a):
        w = _so3_f32(so3_ln, a[0])
        th = np.linalg.norm(w)
        if th < 1e-8:
            Vinv = np.eye(3)
        else:
            wx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
            Vinv = (np.eye(3) - 0.5 * wx
                    + (1 / th**2 - (1 + np.cos(th)) / (2 * th * np.sin(th))) * (wx @ wx))
        return np.concatenate([Vinv @ a[1], w])

    def se3_exp(v):
        R = _so3_f32(so3_exp, v[3:])
        w = v[3:]
        th = np.linalg.norm(w)
        if th < 1e-8:
            V = np.eye(3)
        else:
            wx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
            V = (np.eye(3) + (1 - np.cos(th)) / th**2 * wx
                 + (th - np.sin(th)) / th**3 * (wx @ wx))
        return R, V @ v[:3]

    def gen_field(m, p4):
        """SE3 generator field on a homogeneous point (TooN convention)."""
        out = np.zeros(4)
        if m < 3:
            out[m] = p4[3]
        else:
            w = np.zeros(3)
            w[m - 3] = 1.0
            out[:3] = np.cross(w, p4[:3])
        return out

    s = (np.eye(3), np.zeros(3))
    for _ in range(iters):
        H = np.eye(6)          # WLS prior 1.0
        g = np.zeros(6)
        for c, cfb_c in cfb.items():
            rel_c = rel[c]
            err = se3_mul(cfb_c, se3_mul(s, se3_inv(rel_c)))
            err_in_base = se3_mul(s, se3_inv(rel_c))
            v6 = se3_ln(err)
            J = np.zeros((6, 6))
            p4 = np.concatenate([err_in_base[1], [1.0]])
            for m in range(6):
                J[0:3, m] = cfb_c[0] @ gen_field(m, p4)[:3]
            J[3:6, 3:6] = rel_c[0]
            H += J.T @ J
            g += J.T @ v6
        mu = np.linalg.solve(H, g)
        s = se3_mul(se3_inv(se3_exp(mu)), s)
    return s
