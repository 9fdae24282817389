"""Host-side map-maker scheduler (port of mcptam_tpu/system/mapmaker.py,
ref the MapMaker thread's priority loop, src/MapMaker.cc:131-323).

Each tick does one thing, in priority order: integrate a queued MKF
(preempting BA, with partial writeback of what the aborted BA achieved);
advance local BA (``problem_recent``) or global BA (``problem_all``) by one
chunk of ``ba_chunk`` LM steps; finish a BA (writeback, Tukey outlier
pass, outlier routing); or, when idle, garbage-collect bad points and run
the refind sweeps.

Host reads, as in the reference: the live counts once per BA start, the
accept flag once per integration, and the convergence flag of the chunk
dispatched two ticks earlier, which travelled to pinned host memory with
a non-blocking copy and has landed by then.  Nothing inside an LM chunk
or an integration reads back.  ``init`` bootstraps the map from the first
MKF and reads its point count once.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass, field

import torch

from mcptam_tpu_torch.ba.adjusters import (
    apply_outliers, compact_problem, expand_outliers, problem_all,
    problem_live_counts, problem_recent, writeback,
)
from mcptam_tpu_torch.ba.bundle import (
    attach_obs_table, create_lm_state, lm_run, max_obs_per_point,
    point_depth_covariance, tukey_outlier_pass,
)
from mcptam_tpu_torch.config import (
    DEFAULT_BUNDLE, DEFAULT_MAPMAKER, BundleConfig, MapMakerConfig,
)
from mcptam_tpu_torch.map.mapmaker_core import init_from_mkf, integrate_mkf_device
from mcptam_tpu_torch.map.refind import refind_in_keyframes
from mcptam_tpu_torch.map.state import (
    MapState, clone_tree, count_mkfs, count_points, move_bad_points_to_trash,
)
from mcptam_tpu_torch.system import timing
from mcptam_tpu_torch.system.timing import MapMakerTiming, span

MM_INITIALIZING = 0
MM_RUNNING = 1

BA_CHUNK = 5   # LM steps per scheduler tick (preemption granularity)

_log = logging.getLogger(__name__)


def _bucket(n: int, buckets) -> int:
    """Smallest bucket >= n (the last bucket if none)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _to_host(x: torch.Tensor):
    """Start a non-blocking device->host copy; returns (host tensor, event),
    the event None on the CPU."""
    if not x.is_cuda:
        return x, None
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


@dataclass
class MapMaker:
    """Owns the map-building schedule; ``step()`` runs its ticks."""

    cams: object
    mcfg: MapMakerConfig = field(default_factory=lambda: DEFAULT_MAPMAKER)
    bcfg: BundleConfig = field(default_factory=lambda: DEFAULT_BUNDLE)
    state: int = MM_INITIALIZING
    queue: list = field(default_factory=list)   # pending (feats, pose, result, cam_active)
    failed_ba_count: int = 0
    last_timing: MapMakerTiming = field(default_factory=MapMakerTiming)
    ba_chunk: int = BA_CHUNK
    init_point_cov: float = float("inf")
    # every finished BA: (kind, accepted, total iterations)
    ba_log: list = field(default_factory=list)

    _ba_kind: str = "none"       # none | local | global
    _ba_prob: object = None
    _ba_state: object = None
    _ba_steps: int = 0
    _conv_pending: list = field(default_factory=list)
    _local_done: bool = False    # local BA converged since the last MKF
    _global_done: bool = False
    _idle_ticks: int = 0

    # -- problems ----------------------------------------------------------
    def _sized_table(self, prob, dmax: int):
        """Attach the observation table with D sized from the data:
        bucketed, floored at obs_cap, capped at 64."""
        D = _bucket(max(dmax, 1), (8, 16, 24, 32, 48, 64))
        return attach_obs_table(prob, max(min(D, 64), min(self.bcfg.obs_cap, 64)))

    def _local_problem(self, ms: MapState):
        prob = compact_problem(problem_recent(ms, self.bcfg.recent_num))
        return self._sized_table(prob, int(max_obs_per_point(prob)))

    def _global_problem(self, ms: MapState):
        """The compacted global problem: fetch the live sizes (one sync),
        pick the bucketed capacities, build."""
        prob = problem_all(ms)
        n_pt, n_m = problem_live_counts(prob)
        n_pt, n_m, dmax = (int(x) for x in torch.stack(
            [n_pt, n_m, max_obs_per_point(prob)]).cpu())
        mp = min(_bucket(n_pt, (512, 1024, 2048, 4096)), ms.points.capacity)
        mm = min(_bucket(n_m, (4096, 8192, 16384, 32768)), ms.meas.capacity)
        if n_pt > mp or n_m > mm:
            _log.warning("global BA compaction clipped the problem: %d live "
                         "points -> %d slots, %d live measurements -> %d slots",
                         n_pt, mp, n_m, mm)
        return self._sized_table(compact_problem(prob, max_points=mp, max_meas=mm),
                                 dmax)

    def _lm_run(self, prob, st):
        # problem_recent / problem_all never move the extrinsics, so the
        # pose-b system is elided (fixed_b)
        return lm_run(prob, st, self.cams, self.ba_chunk, self.bcfg, fixed_b=True)

    def _finish(self, ms, prob, st):
        ms = writeback(ms, prob, st)
        outliers = tukey_outlier_pass(prob, st, self.cams)
        return apply_outliers(ms, expand_outliers(prob, outliers, ms.meas.capacity))

    def _resolve_epi_budget(self, ms: MapState):
        """epi_max_hypotheses == 0 means AUTO: the arc budget bucketed from
        the rig's worst-case arc length, resolved once on the host."""
        if self.mcfg.epi_max_hypotheses != 0:
            return
        from mcptam_tpu_torch.map.epipolar import auto_hypothesis_budget
        nh = auto_hypothesis_budget(
            self.cams, ms.cam_from_base,
            finest_level=0 if self.mcfg.level_zero_points else 1,
            kf_baseline=self.mcfg.max_scaled_mkf_dist * self.mcfg.init_depth)
        self.mcfg = dataclasses.replace(
            self.mcfg, epi_max_hypotheses=nh,
            epi_corner_ambiguity=self.mcfg.epi_corner_ambiguity or nh > 32)

    # -- tracker-facing API (MapMakerClientBase) ----------------------------
    def init(self, ms: MapState, feats, pose):
        """Blocking map init from the first MKF (MapMaker::Init).  Returns
        (ms, ok).  Init fails, leaving ``ms`` untouched, when fewer than
        ``mcfg.min_map_points`` points could be made (snMinMapPoints,
        src/MapMakerServerBase.cc:146-261); the caller retries on a later
        frame."""
        self._resolve_epi_budget(ms)
        ms2, _ = init_from_mkf(clone_tree(ms), self.cams, feats, pose, self.mcfg)
        if int(count_points(ms2)) < self.mcfg.min_map_points:
            return ms, False
        self.state = MM_INITIALIZING
        self._reset_ba()
        return ms2, True

    def add_mkf(self, feats, pose, tracker_result, cam_active=None):
        """Queue an MKF; it preempts BA at the next tick."""
        self.queue.append((feats, pose, tracker_result, cam_active))

    def queue_size(self) -> int:
        return len(self.queue)

    def reset(self, ms: MapState = None):
        self.queue.clear()
        self.state = MM_INITIALIZING
        self._reset_ba()
        self.failed_ba_count = 0

    # -- scheduler ---------------------------------------------------------
    def _reset_ba(self):
        self._ba_kind = "none"
        self._ba_prob = None
        self._ba_state = None
        self._ba_steps = 0
        self._local_done = False
        self._global_done = False
        self._conv_pending = []

    def step(self, ms: MapState, budget_s: float | None = None) -> MapState:
        """One tick; with a budget, ticks repeat until the wall-clock budget
        is spent or the map-maker goes idle (duty_budget_ms)."""
        ms = self._tick(ms)
        if budget_s is not None:
            t_end = time.perf_counter() + budget_s
            while time.perf_counter() < t_end:
                if (not self.queue and self._ba_kind == "none"
                        and self._local_done and self._global_done):
                    break
                ms = self._tick(ms)
        return ms

    def _tick(self, ms: MapState) -> MapState:
        """One scheduler tick, in a ``mapmaker.tick`` span named by its
        kind: ``:integrate``, ``:ba_chunk`` or ``:idle``."""
        with span("mapmaker.tick") as sp:
            return self._tick_in(ms, sp)

    def _tick_in(self, ms: MapState, sp) -> MapState:
        t0 = time.perf_counter()

        # 1. a queued MKF first (preempts BA)
        if self.queue:
            sp.tag("integrate")
            if (self._ba_kind != "none" and self._ba_state is not None
                    and int(self._ba_state.accepted) > 0):
                # apply what the aborted BA achieved
                ms = writeback(ms, self._ba_prob, self._ba_state)
            self._reset_ba()
            feats, pose, result, cam_active = self.queue.pop(0)
            if cam_active is None:
                cam_active = torch.ones(ms.cam_from_base.t.shape[0], dtype=torch.bool,
                                        device=ms.mkfs.valid.device)
            self._resolve_epi_budget(ms)
            # integration updates its map in place: run it on a copy, kept
            # only if the MKF is accepted
            ms_new, _, n_large, slot_ok = integrate_mkf_device(
                clone_tree(ms), self.cams, feats, pose, result, self.mcfg,
                cam_active=cam_active)
            slot_ok_h, n_large_h = (int(x) for x in torch.stack(
                [slot_ok.to(torch.int64), n_large.to(torch.int64)]).cpu())
            accepted = bool(slot_ok_h) and (not self.mcfg.large_point_test
                                            or n_large_h > 0)
            if accepted:
                ms = ms_new
            self.last_timing = MapMakerTiming(
                elapsed=time.perf_counter() - t0,
                kind="creation" if accepted else "creation-rejected")
            return ms

        # 2. bundle adjustment
        if self._ba_kind == "none":
            if not self._local_done:
                # local BA only once the map is big enough (snRecentMinSize)
                if int(count_mkfs(ms)) < self.bcfg.recent_min_size:
                    self._local_done = True
                    return self._tick_in(ms, sp)
                self._ba_kind = "local"
                self._ba_prob = self._local_problem(ms)
            elif not self._global_done:
                self._ba_kind = "global"
                self._ba_prob = self._global_problem(ms)
            else:
                # idle: trash GC, then the refind sweeps — the general one
                # (ReFindNewlyMade) and, 1 loop in 20, the failure queue
                sp.tag("idle")
                ms = move_bad_points_to_trash(ms)
                self._idle_ticks += 1
                n_refound = 0
                if self._idle_ticks % 20 == 10:
                    ms, n_refound = refind_in_keyframes(ms, self.cams)
                elif self._idle_ticks % 20 == 0 and bool(torch.any(ms.retry_queue)):
                    ms, n_refound = refind_in_keyframes(ms, self.cams,
                                                        pair_mask=ms.retry_queue)
                if int(n_refound) > 0:
                    self._local_done = False
                    self._global_done = False
                return ms
            self._ba_state = create_lm_state(self._ba_prob, self.bcfg)
            self._ba_steps = 0

        # one chunk; read the convergence flag of the chunk dispatched two
        # ticks ago, whose copy has landed
        sp.tag("ba_chunk")
        self._ba_state = self._lm_run(self._ba_prob, self._ba_state)
        self._conv_pending.append(_to_host(self._ba_state.converged))
        self._ba_steps += self.ba_chunk
        converged = False
        if len(self._conv_pending) > 2:
            host, ev = self._conv_pending.pop(0)
            timing.wait(ev)
            converged = bool(host)
        exhausted = self._ba_steps >= self.bcfg.max_iterations

        if converged or exhausted:
            st, prob = self._ba_state, self._ba_prob
            accepted, total_iters, n_drop = (int(x) for x in torch.stack(
                [st.accepted, st.iterations, prob.obs_dropped]).cpu())
            if n_drop > 0:
                _log.warning("%s BA: the observation table dropped %d "
                             "measurements from the normal equations",
                             self._ba_kind, n_drop)
            if accepted > 0:
                ms = self._finish(ms, prob, st)
                self.failed_ba_count = 0
            else:
                self.failed_ba_count += 1
            self.last_timing = MapMakerTiming(
                elapsed=time.perf_counter() - t0, accepted_iterations=accepted,
                total_iterations=total_iters, kind=self._ba_kind)
            self.ba_log.append((self._ba_kind, accepted, total_iters))
            if self._ba_kind == "local":
                self._local_done = True
            else:
                self._global_done = True
                # init gate (src/MapMaker.cc:288-295): median point depth
                # covariance below threshold -> RUNNING
                if self.state == MM_INITIALIZING:
                    self.init_point_cov = float(point_depth_covariance(
                        prob, st, self.cams)[0])
                    if self.init_point_cov < self.mcfg.init_cov_thresh:
                        self.state = MM_RUNNING
            self._ba_kind = "none"
            self._ba_prob = None
            self._ba_state = None
            self._conv_pending = []
        return ms

    def stop_init(self):
        """Force the end of initialisation (RequestStopInit)."""
        self.state = MM_RUNNING

    def on_map_changed(self):
        """New measurements or points invalidate the BA convergence latches."""
        self._local_done = False
        self._global_done = False

    @property
    def reset_requested(self) -> bool:
        """Five consecutive failed BAs request a system reset
        (src/MapMaker.cc:216-224)."""
        return self.failed_ba_count >= 5
