"""The mapping mix: the mcptam app mapping ground it has not seen.

A closed loop over ``System.process_frames``: B frames a call, a pipeline
of ``pipeline_depth`` frames, the map-maker ticked every ``tick_every``-th
batch (``duty_budget_ms`` 0: one tick) with keyframe adds on, as the app
runs with ``--batch 8 --pipeline 2``.  Set-up renders one pass of an open
lateral sweep on the device from the seed (rows ``width`` wide, ``rows``
of them ``row_gap`` apart, each turn rounded over ``turn_radius``,
``step`` a frame, the tracking loop's small rotational wobble; the seed
draws the texture's seed and whether the sweep starts leftward or
rightward), builds the ground-truth map at the sweep's first pose through
the program's API, and warms up with the pass's first batches.  The window
hands in the pass's next B frames a call and counts the FrameInfos the
calls return.  At the end of a pass it puts back the start map, a fresh
tracker at the first pose and a fresh map-maker, from device copies kept
from set-up, and starts the pass again.

Correct.  The program's start map is held against the one the plain
reference builds from the same rendered keyframe.  Before each call the
program's tracker state and map are copied, for a sample of the window's
batches drawn from the seed and its last batch: the reference tracks those
batches from the copies, and the program's pose, covariance, found count
and lost flag are held against it, frame by frame: the pose's and the
covariance's gaps by their median over the judged frames, the found
count by the share of frames on which it differs (one patch of a frame
whose search meets a near-tie may go either way, and moves that frame's
pose as far as TF32 moves every frame's).  Every batch of the window is held to
the add rule: the reference's ``need_new_mkf`` on the program's map (its
keyframes as the batch was handed in), with the program's tracked pose and
mean depth of each frame (taken where the program asks its add rule) and
the poses and depths of the keyframes queued then, picks the frame the
drained batch has to queue, if any; the program's queued frame has to be
it.  Around every integration (``integrate_mkf_device``, the name the
map-maker's tick looks up) the map it starts from and the map it makes are
copied, and kept for a sample of the window's integrations drawn from the
seed and its last: the reference integrates the same keyframe, its
features made again from the rendered frame, from the program's map with
the program's pose and tracker result for it, and the program's map is
held against the reference's, every field.  The map-maker's bundle
adjustment likewise: for a sample of the BAs started in the window, drawn
from the seed, and its last, the map each was built from is copied
(``problem_recent`` / ``problem_all``, the names the tick looks up), and
the state before and after its first and its latest chunk in the window
(``lm_run``); the reference builds the problem again from that map and
holds the program's to it, runs the first chunk from its own start and
the latest from the program's state before it, and holds the poses and
the first change to it.  Each writeback of the sampled kind (``writeback``:
a finished or preempted BA into the map) is held to the reference's from
the same map, problem and state.  The gates stand beside it: no frame
lost, the pose error against the rendered sweep, and the keyframes
accepted per 100 frames returned.
"""

from __future__ import annotations

import dataclasses
import random
import sys
import time
import types

import numpy as np
import torch

from drivers.track import pose_error, precision, reference_track, tracker_config
from faults import patch
from harness.convert import clone_tree, to_host, to_program, to_reference, tree_gaps

UNIT = "frames"
# window calls of a reading for the limits (control.py): a few integrations
CONTROL_CALLS = lambda mix: mix["control_calls"]  # noqa: E731
QUEUE_SLOTS = 2        # queued keyframes the add rule measures against (System)
ACCEPTED = "mkfs_accepted"
RENDER_CHUNK = 32      # poses a rendering call (~1 GB of intermediates at 480x640)
BA_CHUNK = 5           # LM steps a map-maker tick runs (the app's, system/mapmaker.py)


# -- the sweep -----------------------------------------------------------------

def sweep_xy(traj: dict) -> np.ndarray:
    """(n, 2) positions of one pass: a boustrophedon of ``rows`` rows of
    ``width`` joined by ``row_gap`` connectors, every corner rounded by an
    arc of ``turn_radius``, sampled every ``step`` of arc length, cut to
    whole batches by the caller."""
    w, gap, r = traj["width"], traj["row_gap"], traj["turn_radius"]
    ys = (np.arange(traj["rows"]) - (traj["rows"] - 1) / 2.0) * gap
    corners = []
    for k, y in enumerate(ys):
        xs = (-w / 2, w / 2) if k % 2 == 0 else (w / 2, -w / 2)
        corners += [np.array([xs[0], y]), np.array([xs[1], y])]
    pieces = []            # ("line", a, b) or ("arc", centre, start angle, signed sweep)
    start = corners[0]
    for i in range(1, len(corners) - 1):
        p = corners[i]
        u = (p - corners[i - 1]) / np.linalg.norm(p - corners[i - 1])
        v = (corners[i + 1] - p) / np.linalg.norm(corners[i + 1] - p)
        t1, centre = p - u * r, p - u * r + v * r
        pieces.append(("line", start, t1))
        turn = np.sign(u[0] * v[1] - u[1] * v[0])
        a0 = np.arctan2(*(t1 - centre)[::-1])
        pieces.append(("arc", centre, a0, turn * np.pi / 2))
        start = p + v * r
    pieces.append(("line", start, corners[-1]))
    lengths = [np.linalg.norm(pc[2] - pc[1]) if pc[0] == "line" else r * abs(pc[3])
               for pc in pieces]
    ends = np.cumsum(lengths)
    out = []
    for s in np.arange(0.0, ends[-1] + 1e-9, traj["step"]):
        i = min(int(np.searchsorted(ends, s, side="right")), len(pieces) - 1)
        f = s - (ends[i] - lengths[i])
        pc = pieces[i]
        if pc[0] == "line":
            out.append(pc[1] + (pc[2] - pc[1]) * (f / max(lengths[i], 1e-12)))
        else:
            a = pc[2] + np.sign(pc[3]) * f / r
            out.append(pc[1] + r * np.array([np.cos(a), np.sin(a)]))
    return np.stack(out)


def seed_params(seed: int, mix: dict) -> tuple:
    """(texture seed, whether the sweep starts leftward) of a run seed."""
    rng = random.Random(seed)
    tex = mix["texture"]["base"] + mix["texture"]["span"] * rng.random()
    return tex, rng.random() < 0.5


def sweep_poses(mix: dict, leftward: bool, dev) -> list:
    """The pass's base_from_world poses (the reference's SE3), whole
    batches of them: the rig at each sweep position, at the world's
    centre depth, with the tracking loop's rotational wobble."""
    from plainref.core.se3 import SE3

    traj = mix["trajectory"]
    xy = sweep_xy(traj)
    xy = xy[: len(xy) // mix["batch"] * mix["batch"]]
    if leftward:
        xy = xy * np.array([-1.0, 1.0])
    amp, period = traj["wobble"]["amplitude"], traj["wobble"]["period_poses"]
    poses = []
    for i, (x, y) in enumerate(xy):
        a = 2.0 * np.pi * i / period
        w = [amp[0] * np.sin(a + 1.3), amp[1] * np.cos(2 * a), amp[2] * np.sin(3 * a + 0.5)]
        R = SE3.exp(torch.tensor([0.0, 0.0, 0.0, *w], dtype=torch.float32, device=dev)).R
        p = torch.tensor([x, y, 0.0], dtype=torch.float32, device=dev)
        poses.append(SE3(R=R, t=-(R @ p)))
    return poses


# -- the session ------------------------------------------------------------------

@dataclasses.dataclass
class Integration:
    """One integration of the window: the map it started from and the map
    it made (device copies, while the sample keeps it), the program's
    arguments for the keyframe, its outputs, and the queued keyframe."""
    index: int
    before: object
    pose: object
    result: object
    cam_active: torch.Tensor
    after: object
    n_large: torch.Tensor
    slot_ok: torch.Tensor
    added: "Added"


@dataclasses.dataclass
class BA:
    """A bundle adjustment started in the window: the builder that made its
    problem and its arguments, the map it was built from (a device copy,
    while the sample keeps it), the program's problem, and (state before,
    state after, LM steps) of its first and of its latest chunk."""
    index: int
    kind: str
    args: tuple
    start: object
    prob: object = None
    first: tuple = None
    last: tuple = None


@dataclasses.dataclass
class Writeback:
    """A BA's result written into the map: the map before and after (device
    copies, while the sample keeps them), the problem and the state."""
    index: int
    before: object
    prob: object
    st: object
    after: object


def reservoir(pool: list, i: int, k: int, rng) -> None:
    """Item i of a stream into a sample of k drawn with ``rng``."""
    if len(pool) < k:
        pool.append(i)
    else:
        j = rng.randrange(i + 1)
        if j < k:
            pool[j] = i


@dataclasses.dataclass
class Added:
    """A keyframe queued in a call; its frame id is known once the call's
    FrameInfos are back."""
    fid: int = -1


@dataclasses.dataclass
class Call:
    """One window call, as the add rule saw it: the map's keyframes and
    the queued keyframes' poses and depths when the batch was handed in,
    each frame's pose and mean depth where the add rule was asked, and the
    frame the drained batch queued."""
    fid0: int
    mkfs: tuple                # (R, t, valid, kf_valid, scene_depth_mean)
    queue: list                # [(R, t, mean depth (C,))] of the first QUEUE_SLOTS
    queue_len: int
    asked: list = dataclasses.field(default_factory=list)    # [(R, t, mean depth)]
    queued: int = None         # the frame id queued, None if none
    queued_count_ok: bool = True


@dataclasses.dataclass
class Session:
    cfg: dict
    mix: dict
    seed: int
    dev: torch.device
    sync: object
    frames: torch.Tensor          # (n, C, H, W) uint8: frame i of the pass
    gt: list                      # ground-truth (R, t) of frame i
    poses_r: list                 # the reference's SE3 of frame i
    cams_r: object
    cfb_r: object
    tex: float
    side: object = None           # ProgramSide or ReferenceSide
    ms0: object = None            # the start map, a host copy
    next_fid: int = 0
    passes: int = 0
    recording: bool = False       # while the window runs
    snaps: dict = dataclasses.field(default_factory=dict)    # fid0 -> (ts, ms)
    infos: dict = dataclasses.field(default_factory=dict)    # fid -> (pose, cov, found, lost)
    quality: dict = dataclasses.field(default_factory=dict)  # fid -> quality
    window_fids: list = dataclasses.field(default_factory=list)
    judged: list = dataclasses.field(default_factory=list)
    calls: list = dataclasses.field(default_factory=list)    # Call of each window call
    call_adds: list = dataclasses.field(default_factory=list)
    integrations: list = dataclasses.field(default_factory=list)  # Integration, in order
    int_pool: list = dataclasses.field(default_factory=list)
    int_rng: object = None
    accepted: int = 0
    pass_counts: list = dataclasses.field(default_factory=list)  # map sizes at each pass's end
    undo: list = dataclasses.field(default_factory=list)
    bas: list = dataclasses.field(default_factory=list)         # BA, in order
    ba_pool: list = dataclasses.field(default_factory=list)
    wbs: list = dataclasses.field(default_factory=list)         # Writeback, in order
    wb_pool: list = dataclasses.field(default_factory=list)
    rng: object = None            # the judge's samples of integrations, BAs, writebacks
    t_in: dict = dataclasses.field(default_factory=dict)      # fid -> when it was handed in
    latencies: list = dataclasses.field(default_factory=list)  # seconds, frames returned
    timed: bool = True            # latencies kept (off in the profiled slice)

    @property
    def n(self) -> int:
        return self.frames.shape[0]

    def record_integration(self, before, pose, result, cam_active, out, added):
        """Keep an integration of the window while the sample holds it (a
        reservoir of the window's integrations drawn from the seed) or it is
        the newest."""
        i = len(self.integrations)
        reservoir(self.int_pool, i, self.mix["judge"]["integrations"], self.int_rng)
        ms, _, n_large, slot_ok = out
        self.integrations.append(Integration(i, before, pose, result, cam_active,
                                             clone_tree(ms), n_large, slot_ok, added))
        for e in self.integrations[:-1]:
            if e.index not in self.int_pool and e.before is not None:
                e.before = e.after = None

    def record_ba_start(self, kind: str, args: tuple, ms):
        """A BA's problem is built from ``ms``: keep a copy of the map while
        the sample holds the BA or it is the newest."""
        i = len(self.bas)
        reservoir(self.ba_pool, i, self.mix["judge"]["bas"], self.rng)
        self.bas.append(BA(i, kind, args, clone_tree(ms)))
        for b in self.bas[:-1]:
            if b.index not in self.ba_pool and b.start is not None:
                b.start = b.prob = b.first = b.last = None

    def record_chunk(self, prob, before, after, n_steps: int):
        """A chunk of the newest BA, if it started in the window."""
        b = self.bas[-1] if self.bas else None
        if b is None or b.start is None or (b.prob is not None and b.prob is not prob):
            return
        b.prob = prob
        kept = (clone_tree(before), clone_tree(after), n_steps)
        if b.first is None:
            b.first = kept
        else:
            b.last = kept

    def record_writeback(self, before, prob, st, after):
        i = len(self.wbs)
        reservoir(self.wb_pool, i, self.mix["judge"]["writebacks"], self.rng)
        self.wbs.append(Writeback(i, before, prob, clone_tree(st), clone_tree(after)))
        for w in self.wbs[:-1]:
            if w.index not in self.wb_pool and w.before is not None:
                w.before = w.prob = w.st = w.after = None


def mapmaker_config(pkg: str, cfg: dict, mix: dict):
    import importlib
    c = importlib.import_module(f"{pkg}.config")
    return c.MapMakerConfig(**{**cfg["mapmaker"], "duty_budget_ms": mix["duty_budget_ms"]})


def render_pass(cams_r, cfb_r, R_bw, t_bw, tex: float, H: int, W: int) -> torch.Tensor:
    """(n, C, H, W) uint8 frames of the poses (R_bw (n,3,3), t_bw (n,3)):
    the world of ``plainref.io.synthetic.render_view`` (the textured sphere
    seen from inside), each camera's rays unprojected once and
    ``RENDER_CHUNK`` poses rendered a call."""
    from plainref.io.synthetic import SPHERE_RADIUS, texture
    from plainref.core.camera import unproject

    dev = R_bw.device
    n, C = R_bw.shape[0], cfb_r.t.shape[0]
    frames = torch.empty((n, C, H, W), dtype=torch.uint8, device=dev)
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    for c in range(C):
        rays_c = unproject(cams_r[c], torch.stack([xs, ys], -1))         # (H,W,3)
        R_cw = cfb_r.R[c] @ R_bw                                           # (n,3,3)
        t_cw = torch.einsum("ij,nj->ni", cfb_r.R[c], t_bw) + cfb_r.t[c]
        R_wc = R_cw.transpose(-1, -2)
        c_w = -torch.einsum("nij,nj->ni", R_wc, t_cw)                      # camera centres
        for p0 in range(0, n, RENDER_CHUNK):
            Rw, cw = R_wc[p0:p0 + RENDER_CHUNK], c_w[p0:p0 + RENDER_CHUNK]
            d = torch.einsum("pij,hwj->phwi", Rw, rays_c)
            b = torch.einsum("phwi,pi->phw", d, cw)
            disc = b * b - (torch.sum(cw * cw, -1) - SPHERE_RADIUS ** 2)[:, None, None]
            t = -b + torch.sqrt(torch.clamp(disc, min=0.0))
            img = texture(cw[:, None, None, :] + t[..., None] * d, tex)
            frames[p0:p0 + RENDER_CHUNK, c] = torch.clamp(img, 0, 255).to(torch.uint8)
    return frames


def make_inputs(cfg: dict, mix: dict, seed: int, dev):
    """The rig (the reference's classes) and the rendered pass, from the seed."""
    from plainref.io.synthetic import make_rig

    rig = cfg["rig"]
    C, H, W = rig["n_cams"], rig["height"], rig["width"]
    tex, leftward = seed_params(seed, mix)
    cams_r, cfb_r = make_rig(C, H, W, spread_deg=rig["spread_deg"], device=dev)
    poses = sweep_poses(mix, leftward, dev)
    R, t = torch.stack([p.R for p in poses]), torch.stack([p.t for p in poses])
    frames = render_pass(cams_r, cfb_r, R, t, tex, H, W)
    return cams_r, cfb_r, frames, list(zip(R.cpu().numpy(), t.cpu().numpy())), poses, tex


def _new_session(cfg, mix, seed, dev, sync) -> Session:
    cams_r, cfb_r, frames, gt, poses_r, tex = make_inputs(cfg, mix, seed, dev)
    sess = Session(cfg, mix, seed, dev, sync, frames, gt, poses_r, cams_r, cfb_r, tex)
    sess.int_rng = random.Random(seed ^ 0x1A7E)
    sess.rng = random.Random(seed ^ 0xBA)
    return sess


# -- the program's side --------------------------------------------------------------

class ProgramSide:
    """The program's System over the start map, and the names the driver
    patches to see what it does: the add rule's arguments
    (``system.need_new_mkf``), the keyframes the map-maker queues (the
    instance's ``add_mkf``) and the integrations (``mapmaker.integrate_mkf_device``)."""

    def __init__(self, sess: Session):
        from mcptam_tpu_torch.io.synthetic import build_groundtruth_map, make_sbi_cams
        from mcptam_tpu_torch.map.state import clone_tree as program_clone
        from mcptam_tpu_torch.system import mapmaker, system

        self.sess = sess
        cfg, mix = sess.cfg, sess.mix
        rig, cap = cfg["rig"], cfg["capacity"]
        H, W = rig["height"], rig["width"]
        self.cams, self.cfb = to_program(sess.cams_r), to_program(sess.cfb_r)
        self.cams_sbi = make_sbi_cams(self.cams, H, W)
        self.tcfg, _ = tracker_config("mcptam_tpu_torch", cfg)
        self.mcfg = mapmaker_config("mcptam_tpu_torch", cfg, mix)
        self.pose0 = to_program(sess.poses_r[0])
        ms, _ = build_groundtruth_map(self.cams, self.cfb, H, W, pose0=self.pose0, seed=sess.tex,
                                      n_per_level=mix["map"]["n_per_level"], **cap)
        sess.ms0 = to_host(ms)
        self.ms_start = program_clone(ms)
        self.clone = program_clone
        self.system = None
        self._install(system, mapmaker)
        self.restart()

    def _install(self, system, mapmaker):
        sess = self.sess
        ask = system.need_new_mkf

        def need_new_mkf(ms, pose, mean_depth, *a, **k):
            if sess.recording and sess.calls:
                sess.calls[-1].asked.append((pose.R.clone(), pose.t.clone(), mean_depth.clone()))
            return ask(ms, pose, mean_depth, *a, **k)

        integrate = mapmaker.integrate_mkf_device
        self.pending = {}          # id(feats) -> Added, while queued

        def integrate_mkf_device(ms, *a, **k):
            added = self.pending.pop(id(a[1]), Added())
            if not sess.recording:
                return integrate(ms, *a, **k)
            before = clone_tree(ms)
            out = integrate(ms, *a, **k)
            sess.record_integration(before, a[2], a[3], k.get("cam_active"), out, added)
            return out

        def builder(name):
            orig = getattr(mapmaker, name)

            def build(ms, *a, **k):
                if sess.recording:
                    sess.record_ba_start(name, a, ms)
                return orig(ms, *a, **k)

            return patch(mapmaker, name, build)

        run = mapmaker.lm_run

        def lm_run(prob, st, cams, n_steps, *a, **k):
            if not sess.recording:
                return run(prob, st, cams, n_steps, *a, **k)
            before = clone_tree(st)
            out = run(prob, st, cams, n_steps, *a, **k)
            sess.record_chunk(prob, before, out, n_steps)
            return out

        wb = mapmaker.writeback

        def writeback(ms, prob, st):
            if not sess.recording:
                return wb(ms, prob, st)
            before = clone_tree(ms)
            out = wb(ms, prob, st)
            sess.record_writeback(before, prob, st, out)
            return out

        sess.undo += [patch(system, "need_new_mkf", need_new_mkf),
                      patch(mapmaker, "integrate_mkf_device", integrate_mkf_device),
                      builder("problem_recent"), builder("problem_all"),
                      patch(mapmaker, "lm_run", lm_run), patch(mapmaker, "writeback", writeback)]

    def restart(self):
        """A fresh System over a copy of the start map, the tracker at the
        pass's first pose, a fresh map-maker; frame ids carry on."""
        from mcptam_tpu_torch.system.system import System

        sess, cfg, mix = self.sess, self.sess.cfg, self.sess.mix
        rig, cap = cfg["rig"], cfg["capacity"]
        s = System(self.cams, self.cfb, self.cams_sbi, rig["height"], rig["width"],
                   tcfg=self.tcfg, mcfg=self.mcfg, pipeline_depth=mix["pipeline_depth"], **cap)
        s.ms, s.initialized = self.clone(self.ms_start), True
        s.ts.pose = self.clone(self.pose0)
        s.vars["AddingMKFs"] = bool(mix["adding_mkfs"])
        s.tick_every = int(mix["tick_every"]) or sys.maxsize
        s.frame_count = sess.next_fid
        self.pending = {}
        mm = s.mapmaker
        add = mm.add_mkf

        def add_mkf(feats, *a, **k):
            n0 = len(mm.queue)
            add(feats, *a, **k)
            if len(mm.queue) > n0:
                self.pending[id(feats)] = a_ = Added()
                sess.call_adds.append(a_)

        mm.add_mkf = add_mkf
        self.system = s

    @property
    def ms(self):
        return self.system.ms

    @property
    def ts(self):
        return self.system.ts

    def counts(self) -> torch.Tensor:
        """(points, keyframes, measurements) in the program's map, on the device."""
        ms = self.system.ms
        return torch.stack([torch.sum(ms.points.valid & ~ms.points.bad), torch.sum(ms.mkfs.valid),
                            torch.sum(ms.meas.valid)])

    def queued(self) -> list:
        """(R, t, per-camera mean depth) of each keyframe in the map-maker's queue."""
        return [(pose.R, pose.t, res.mean_depth) for _, pose, res, _ in self.system.mapmaker.queue]

    def process(self, images) -> list:
        return self.system.process_frames(images)


# -- the reference in the program's place (the precision control) -----------------------

@dataclasses.dataclass
class RefInfo:
    """The reference's answer for a frame, in FrameInfo's names."""
    pose: np.ndarray
    cov_raw: np.ndarray
    n_found: int
    lost: bool
    quality: int
    frame_id: int
    added_mkf: bool = False


def queue_slots(queue: list, dev) -> tuple:
    """The queued keyframes' poses and depths in the add rule's static
    slots, the empty ones identity, as the System lays them out."""
    eye = torch.eye(3, device=dev)
    qR = [eye] * QUEUE_SLOTS
    qt = [torch.zeros(3, device=dev)] * QUEUE_SLOTS
    qd = [torch.ones((), device=dev)] * QUEUE_SLOTS
    qv = [torch.zeros((), dtype=torch.bool, device=dev)] * QUEUE_SLOTS
    for i, (R, t, depth) in enumerate(queue[:QUEUE_SLOTS]):
        qR[i], qt[i], qd[i] = R, t, torch.mean(depth)
        qv[i] = torch.ones((), dtype=torch.bool, device=dev)
    return tuple(torch.stack(x) for x in (qR, qt, qd, qv))


def reference_add(mkfs, slots, R, t, mean_depth, mcfg):
    """The reference's add rule for one frame: (add, scaled distance)."""
    from plainref.core.se3 import SE3
    from plainref.map.mapmaker_core import need_new_mkf
    from plainref.map.state import MKFArrays, MapState, pose_depth_distance

    mR, mt, valid, kf_valid, depth = mkfs
    ms = MapState(points=None, meas=None, cam_from_base=None, next_seq=None, no_retry=None,
                  retry_queue=None,
                  mkfs=MKFArrays(base_from_world=SE3(R=mR, t=mt), valid=valid, fixed=None,
                                 kf_valid=kf_valid, scene_depth_mean=depth,
                                 scene_depth_sigma=None, atlas=None, corner_atlas=None,
                                 sbi=None, sbi_gx=None, sbi_gy=None, seq=None))
    pose = SE3(R=R, t=t)
    qR, qt, qd, qv = slots
    dq = pose_depth_distance(pose, mean_depth, SE3(R=qR, t=qt), qd)
    queue_dist = torch.min(torch.where(qv, dq, torch.full_like(dq, float("inf"))))
    return need_new_mkf(ms, pose, mean_depth, mcfg, queue_dist=queue_dist)


class ReferenceSide:
    """The plain reference in the program's place: the batch loop of
    ``System.process_frames`` with each batch drained in its own call (the
    mix's pipeline is shorter than a batch), tracking each frame, asking
    the add rule, queueing at most one keyframe a batch (the newest
    qualifying frame, its features made again), and every
    ``tick_every``-th batch integrating the oldest queued keyframe, or
    else advancing a bundle adjustment by a chunk as the map-maker's tick
    does (local BA once the map holds ``recent_min_size`` keyframes, then
    global, each to convergence or the iteration cap, written back with its
    outliers routed; a queued keyframe preempts it).  Idle ticks run no
    refind: no number of the cell compares it."""

    def __init__(self, sess: Session, tf32: bool):
        from plainref.io.synthetic import make_sbi_cams

        self.sess, self.tf32 = sess, tf32
        rig = sess.cfg["rig"]
        self.cams_sbi = make_sbi_cams(sess.cams_r, rig["height"], rig["width"])
        self.tcfg, _ = tracker_config("plainref", sess.cfg)
        self.mcfg = mapmaker_config("plainref", sess.cfg, sess.mix)
        self.ms_start = reference_map(sess, tf32)
        sess.ms0 = to_host(self.ms_start)
        self.restart()

    def restart(self):
        from plainref.tracker.tracker import create_tracker_state

        self.ms = clone_tree(self.ms_start)
        self.ts = create_tracker_state(self.sess.cfg["rig"]["n_cams"], self.sess.dev)
        self.ts.pose = clone_tree(self.sess.poses_r[0])
        self.queue = []             # (feats, pose, result, Added) of each queued keyframe
        self.batches = 0
        self.ba = None              # [problem, state, LM steps, builder] of the running BA
        self.local_done = self.global_done = False

    def queued(self) -> list:
        return [(pose.R, pose.t, res.mean_depth) for _, pose, res, _ in self.queue]

    def process(self, images) -> list:
        from plainref.map.keyframe import make_frame_features
        from plainref.map.mapmaker_core import integrate_mkf_device
        from plainref.tracker.tracker import QUALITY_GOOD, apply_tracker_point_stats, track_frame

        sess, mix, mcfg = self.sess, self.sess.mix, self.mcfg
        dev = sess.dev
        active = torch.ones(sess.cfg["rig"]["n_cams"], dtype=torch.bool, device=dev)
        fid0 = sess.next_fid
        slots = queue_slots(self.queued(), dev)
        infos, results, adds = [], [], []
        with precision(self.tf32):
            for j, img in enumerate(images):
                feats = make_frame_features(img)
                self.ts, res = track_frame(self.ts, self.ms, sess.cams_r, self.cams_sbi, feats,
                                           self.tcfg, cam_active=active)
                self.ms = apply_tracker_point_stats(self.ms, res, mcfg.min_outliers,
                                                    mcfg.outlier_multiplier, enable=~res.lost)
                md = torch.mean(res.mean_depth)
                if sess.recording and sess.calls:
                    sess.calls[-1].asked.append((res.pose.R.clone(), res.pose.t.clone(),
                                                 md.clone()))
                mk = self.ms.mkfs
                add, _ = reference_add((mk.base_from_world.R, mk.base_from_world.t, mk.valid,
                                        mk.kf_valid, mk.scene_depth_mean),
                                       slots, res.pose.R, res.pose.t, md, mcfg)
                adds.append(bool(add & (res.quality == QUALITY_GOOD) & ~res.lost))
                pose = torch.cat([res.pose.R, res.pose.t[:, None]], 1)
                infos.append(RefInfo(pose.cpu().numpy(), res.cov.cpu().numpy(),
                                     int(res.tot_found), bool(res.lost), int(res.quality),
                                     fid0 + j))
                results.append(res)
            want = [j for j, a in enumerate(adds) if a and not infos[j].lost]
            if mix["adding_mkfs"] and want and len(self.queue) <= 2:
                j = want[-1]
                res = results[j]
                added = Added()
                sess.call_adds.append(added)
                self.queue.append((make_frame_features(images[j].to(torch.float32)), res.pose,
                                   res, added))
                infos[j].added_mkf = True
            self.batches += 1
            if self.batches % mix["tick_every"] == 0 and not self.queue:
                self.ba_tick()
            elif self.batches % mix["tick_every"] == 0:
                if self.ba is not None and int(self.ba[1].accepted) > 0:
                    self.ms = self.writeback(self.ms, self.ba[0], self.ba[1])
                self.ba, self.local_done, self.global_done = None, False, False
                feats, pose, res, added = self.queue.pop(0)
                before = clone_tree(self.ms)
                out = integrate_mkf_device(clone_tree(self.ms), sess.cams_r, feats, pose, res,
                                           mcfg, cam_active=active)
                if sess.recording:
                    sess.record_integration(before, pose, res, active, out, added)
                if bool(out[3]) and (not mcfg.large_point_test or int(out[2]) > 0):
                    self.ms = out[0]
        return infos

    def writeback(self, ms, prob, st):
        from plainref.ba.adjusters import writeback

        before = clone_tree(ms)
        out = writeback(ms, prob, st)
        if self.sess.recording:
            self.sess.record_writeback(before, prob, st, out)
        return out

    def ba_tick(self):
        """A chunk of the running BA, a new one started first (the problem
        sized by the map-maker's buckets), its result written back once it
        converges or reaches the cap."""
        from plainref.ba.adjusters import (apply_outliers, compact_problem, expand_outliers,
                                           problem_all, problem_live_counts, problem_recent)
        from plainref.ba.bundle import (attach_obs_table, create_lm_state, lm_run,
                                        max_obs_per_point, tukey_outlier_pass)
        from plainref.map.state import count_mkfs

        from drivers.ba import bundle_config

        sess, ms = self.sess, self.ms
        bcfg = bundle_config("plainref", sess.cfg)

        def bucket(n, sizes):
            return next((b for b in sizes if n <= b), sizes[-1])

        if self.ba is None:
            if not self.local_done and int(count_mkfs(ms)) < bcfg.recent_min_size:
                self.local_done = True
            if not self.local_done:
                kind, args = "problem_recent", (bcfg.recent_num,)
                prob = compact_problem(problem_recent(ms, *args))
                dmax = int(max_obs_per_point(prob))
            elif not self.global_done:
                kind, args = "problem_all", ()
                raw = problem_all(ms)
                n_pt, n_m = (int(x) for x in problem_live_counts(raw))
                dmax = int(max_obs_per_point(raw))
                prob = compact_problem(
                    raw, max_points=min(bucket(n_pt, (512, 1024, 2048, 4096)), ms.points.capacity),
                    max_meas=min(bucket(n_m, (4096, 8192, 16384, 32768)), ms.meas.capacity))
            else:
                return
            if sess.recording:
                sess.record_ba_start(kind, args, ms)
            D = max(min(bucket(max(dmax, 1), (8, 16, 24, 32, 48, 64)), 64), min(bcfg.obs_cap, 64))
            prob = attach_obs_table(prob, D)
            self.ba = [prob, create_lm_state(prob, bcfg), 0, kind]
        prob, st, steps, kind = self.ba
        new = lm_run(prob, st, sess.cams_r, BA_CHUNK, bcfg, fixed_b=True)
        if sess.recording:
            sess.record_chunk(prob, st, new, BA_CHUNK)
        self.ba = [prob, new, steps + BA_CHUNK, kind]
        if bool(new.converged) or steps + BA_CHUNK >= bcfg.max_iterations:
            if int(new.accepted) > 0:
                self.ms = self.writeback(ms, prob, new)
                out = tukey_outlier_pass(prob, new, sess.cams_r)
                self.ms = apply_outliers(self.ms, expand_outliers(prob, out, ms.meas.capacity))
            if kind == "problem_recent":
                self.local_done = True
            else:
                self.global_done = True
            self.ba = None


# -- set-up, window, judge ---------------------------------------------------------------

def setup(cfg: dict, mix: dict, seed: int, dev, sync) -> Session:
    """Inputs from the seed, the program's System over the ground-truth
    map at the sweep's first pose, and the warm-up batches."""
    t0 = time.perf_counter()
    sess = _new_session(cfg, mix, seed, dev, sync)
    sync()
    t_inputs = time.perf_counter() - t0
    sess.side = ProgramSide(sess)
    sync()
    t_map = time.perf_counter() - t0 - t_inputs
    for _ in range(mix["warmup_batches"]):
        _call(sess)
    sync()
    print(f"map: set-up s: inputs {t_inputs:.2f} ({sess.n} frames), map and System "
          f"{t_map:.2f}, warm-up {time.perf_counter() - t0 - t_inputs - t_map:.2f}",
          file=sys.stderr)
    return sess


def control_setup(cfg: dict, mix: dict, seed: int, dev, sync) -> Session:
    """The control's session: the same inputs, the reference in TF32 in the
    program's place, warmed up as the program is."""
    sess = _new_session(cfg, mix, seed, dev, sync)
    sess.side = ReferenceSide(sess, tf32=True)
    for _ in range(mix["warmup_batches"]):
        _call(sess)
    return sess


def _call(sess: Session, snap: bool = False) -> int:
    """Hand in the next B frames, the pass put back at its end; keep the
    returned FrameInfos and, while recording, what the add rule saw.
    Returns the frames returned."""
    B = sess.mix["batch"]
    if sess.next_fid and sess.next_fid % sess.n == 0:
        sess.passes += 1
        if sess.recording and hasattr(sess.side, "counts"):
            sess.pass_counts.append(sess.side.counts())
        sess.side.restart()
    fid0 = sess.next_fid
    side = sess.side
    if sess.recording:
        if snap:
            sess.snaps[fid0] = (clone_tree(side.ts), clone_tree(side.ms))
        mk = side.ms.mkfs
        sess.calls.append(Call(
            fid0, tuple(x.clone() for x in (mk.base_from_world.R, mk.base_from_world.t, mk.valid,
                                            mk.kf_valid, mk.scene_depth_mean)),
            [tuple(x.clone() for x in q) for q in side.queued()[:QUEUE_SLOTS]],
            len(side.queued())))
    sess.call_adds = []
    s = fid0 % sess.n
    t_in = time.perf_counter()
    out = side.process(sess.frames[s:s + B])
    t_out = time.perf_counter()
    sess.next_fid += B
    if sess.recording:
        sess.t_in.update({f: t_in for f in range(fid0, fid0 + B)})
        if sess.timed:
            sess.latencies.extend(t_out - sess.t_in[i.frame_id] for i in out
                                  if i.frame_id in sess.t_in)
    flagged = [i.frame_id for i in out if i.added_mkf]
    for a, fid in zip(sess.call_adds, flagged):
        a.fid = fid
    if sess.recording:
        c = sess.calls[-1]
        c.queued = flagged[0] if flagged and sess.call_adds else None
        c.queued_count_ok = len(flagged) == len(sess.call_adds) <= 1
    for i in out:
        sess.infos[i.frame_id] = (i.pose, i.cov_raw, i.n_found, i.lost)
        sess.quality[i.frame_id] = i.quality
    return len(out)


def window(sess: Session, seconds: float, rec, hooks, trace: bool, max_calls: int = 0):
    """The measured window.  With ``trace`` the spans are on for ``seconds``,
    and then whole batches run under the profiler (spans off, launch shapes
    noted) until the slice holds an integrating tick and a BA-chunk tick,
    ``profile_max_batches`` at most; the window ends with them."""
    from harness.trace import profile_slice, summarize

    mix, B = sess.mix, sess.mix["batch"]
    jm = mix["judge"]
    rng = random.Random(sess.seed ^ 0x5EED)
    returned, calls, pool, last = 0, 0, [], None
    diag = []

    def one():
        nonlocal returned, calls, last
        fid0 = sess.next_fid
        t_call = time.perf_counter()
        n_out = _call(sess, snap=True)
        diag.append(round(time.perf_counter() - t_call, 3))
        sess.window_fids.extend(range(fid0, fid0 + B))
        if len(pool) < jm["batches"]:
            pool.append(fid0)
        else:
            j = rng.randrange(calls + 1)
            if j < jm["batches"]:
                pool[j] = fid0
        last = fid0
        for f in list(sess.snaps):
            if f not in pool and f != last:
                del sess.snaps[f]
        calls += 1
        returned += n_out
        return n_out

    def profiled():
        from mcptam_tpu_torch.system import timing

        sess.timed = False         # a profiled call's time holds the profiler's start
        at, frames = timing.mark(), 0
        for _ in range(mix["profile_max_batches"]):
            frames += one()
            if {"mapmaker.tick:integrate", "mapmaker.tick:ba_chunk"} <= {
                    r.name for r in timing.since(at)}:
                break
        return frames

    sess.recording = True
    try:
        t0 = time.perf_counter()
        hooks.spans_on = trace
        while (time.perf_counter() - t0 < seconds or calls < mix["min_calls"]) \
                and not (max_calls and calls >= max_calls):
            one()
        hooks.spans_on = False
        if trace:
            hooks.launches_on = True
            units, events, wall, read_s = profile_slice(profiled, sess.sync)
            hooks.launches_on = False
            rec.slice = summarize(events, wall, units, UNIT, read_s)
        rec.window_s = time.perf_counter() - t0 - (rec.slice or {}).get("read_s", 0.0)
    finally:
        sess.recording = False
        for undo in reversed(sess.undo):
            undo()
        sess.undo = []
    sess.sync()
    sess.judged = sorted(set(pool) | ({last} if last is not None else set()))
    rec.units, rec.attempted, rec.latencies = returned, calls * B, sess.latencies
    large = sess.side.mcfg.large_point_test
    sess.accepted = sum(bool(e.slot_ok) and (not large or int(e.n_large) > 0)
                        for e in sess.integrations)
    rec.counters[ACCEPTED] = sess.accepted
    rec.failed = sum(bool(sess.infos[f][3]) for f in sess.window_fids if f in sess.infos)
    if hasattr(sess.side, "counts"):
        sess.pass_counts.append(sess.side.counts())
    sizes = [tuple(int(x) for x in c.cpu()) for c in sess.pass_counts]
    print(f"map: {calls} calls, {returned} frames, {len(sess.integrations)} integrations "
          f"({sess.accepted} accepted), {sess.passes} passes ended; map (points, keyframes, "
          f"measurements) at each pass's end and the window's: {sizes}; seconds of each call: "
          f"{diag}", file=sys.stderr)


def release(sess: Session):
    """Drop the program's state; the copies the judge needs stay."""
    sess.side = None


def reference_map(sess: Session, tf32: bool = False):
    """The start map as the plain reference builds it from the keyframe
    rendered at the sweep's first pose."""
    from plainref.io.synthetic import build_groundtruth_map

    rig, cap = sess.cfg["rig"], sess.cfg["capacity"]
    with precision(tf32):
        ms, _ = build_groundtruth_map(sess.cams_r, sess.cfb_r, rig["height"], rig["width"],
                                      pose0=sess.poses_r[0], seed=sess.tex,
                                      n_per_level=sess.mix["map"]["n_per_level"], **cap)
    return ms


def split_gaps(gaps: dict) -> tuple:
    """(largest float gap and its field, count of differing integer, flag
    and pixel elements and the fields that differ) of ``tree_gaps``."""
    floats = {k: v for k, v in gaps.items() if isinstance(v, float)}
    exact = {k: v for k, v in gaps.items() if not isinstance(v, float)}
    worst = max(floats, key=floats.get)
    return floats[worst], worst, sum(exact.values()), {k: v for k, v in exact.items() if v}


def judge_adds(sess: Session) -> int:
    """Window calls whose queued keyframe is not the one the reference's add
    rule picks from the same map, poses and depths."""
    from plainref.tracker.tracker import QUALITY_GOOD

    mix, B = sess.mix, sess.mix["batch"]
    mcfg = mapmaker_config("plainref", sess.cfg, mix)
    bad = []
    for c in sess.calls:
        want, seen = [], True
        slots = queue_slots(c.queue, sess.dev)
        for j, (R, t, md) in enumerate(c.asked[:B]):
            fid = c.fid0 + j
            if fid not in sess.infos:
                seen = False
                continue
            add, _ = reference_add(c.mkfs, slots, R, t, md, mcfg)
            lost = sess.infos[fid][3]
            if bool(add) and sess.quality[fid] == QUALITY_GOOD and not lost:
                want.append(fid)
        expected = want[-1] if mix["adding_mkfs"] and want and c.queue_len <= 2 else None
        if len(c.asked) != B or not seen or not c.queued_count_ok or c.queued != expected:
            bad.append((c.fid0, expected, c.queued, len(c.asked)))
    print(f"map: add rule held on {len(sess.calls)} calls; "
          f"{len(bad)} differ (first call, reference, program, frames asked): {bad[:4]}",
          file=sys.stderr)
    return len(bad)


def judge_integrations(sess: Session) -> tuple:
    """(integrate_mismatch, integrate_gap, integrate_points_gap, judged) over
    the sample of the window's integrations."""
    from plainref.map.keyframe import make_frame_features
    from plainref.map.mapmaker_core import integrate_mkf_device
    from plainref.map.state import count_points

    mcfg = mapmaker_config("plainref", sess.cfg, sess.mix)
    mismatch, gap, pts_gap, judged = 0, 0.0, 0.0, 0
    picked = sorted(set(sess.int_pool) | ({len(sess.integrations) - 1}
                                          if sess.integrations else set()))
    for i in picked:
        e = sess.integrations[i]
        if e.added.fid < 0:
            mismatch += 1
            continue
        before = to_reference(e.before)
        feats = make_frame_features(sess.frames[e.added.fid % sess.n].to(torch.float32))
        ms, _, n_large, ok = integrate_mkf_device(
            clone_tree(before), sess.cams_r, feats, to_reference(e.pose), to_reference(e.result),
            mcfg, cam_active=e.cam_active)
        fgap, where, differ, fields = split_gaps(tree_gaps(to_reference(e.after), ms))
        acc_p = bool(e.slot_ok) and (not mcfg.large_point_test or int(e.n_large) > 0)
        acc_r = bool(ok) and (not mcfg.large_point_test or int(n_large) > 0)
        differ += int(acc_p != acc_r) + int(int(e.n_large) != int(n_large))
        new_p = int(count_points(to_reference(e.after))) - int(count_points(before))
        new_r = int(count_points(ms)) - int(count_points(before))
        pgap = abs(new_p - new_r) / max(new_r, 1)
        mismatch, gap, pts_gap = mismatch + differ, max(gap, fgap), max(pts_gap, pgap)
        judged += 1
        print(f"map: integration {i} (frame {e.added.fid}): largest float gap {fgap} ({where}); "
              f"differing elements {fields or 0}; accepted {acc_p} / {acc_r}, large points "
              f"{int(e.n_large)} / {int(n_large)}, new points {new_p} / {new_r}",
              file=sys.stderr)
        e.before = e.after = None
    return mismatch, gap, pts_gap, judged


def movable(prob, start, got, ref) -> tuple:
    """``change_gap``'s (problem, program, reference) over a BA's movable
    points only: a compacted problem's empty slots and its fixed points
    never move, and would set the median point's change to 0."""
    mv = prob.movable_pt & (prob.pt_index_ok if prob.pt_index_ok is not None else True)
    slot = torch.cumsum(mv.to(torch.int64), 0) - 1
    m_point = torch.where(mv[prob.m_point.long()], slot[prob.m_point.long()], -1)

    def cut(st, **k):
        return types.SimpleNamespace(points=st.points[mv], pose_a=st.pose_a, **k)

    return cut(start, m_valid=prob.m_valid, m_point=m_point), cut(got), cut(ref)


def pose_change_gap(look: dict) -> float:
    """``change_gap``'s rule over the pose leaves of its look: the gap of
    the rotations' and the translations' change norms, each over the larger
    of the reference's norm and the median leaf's.  The points' leaves are
    printed, not compared: a local BA's median point moves ~0.7 mm, and a
    step at the noise floor of convergence, accepted on one side only,
    moves it by a few hundredths of that; a global BA's whole norm is set
    by a few weakly observed points."""
    leaves = ("rotation", "translation", "median_point")
    med = sorted(look[k][1] for k in leaves)[1]
    return max((abs(p - q) / max(q, med, 1e-30) for p, q in (look[k] for k in leaves[:2])
                if q >= 1e-3 * med), default=0.0)


def judge_ba(sess: Session) -> tuple:
    """(ba_mismatch, ba_gap, ba_change_gap, ba_pose_gap, BAs judged,
    writebacks judged) over the samples of the window's BAs and writebacks.
    A BA: its problem built again from the map it was built from (the
    program's sizes: points, measurements, the table's D), held against
    the program's, every field; its first chunk run from the reference's
    own start, its latest from the program's state before it, each held by
    the poses after it, the first also by its change (``change_gap``, the
    BA cell's).  A writeback: the reference's from the same map, problem
    and state, held against the program's map, every field."""
    from plainref.ba.adjusters import compact_problem, problem_all, problem_recent, writeback
    from plainref.ba.bundle import attach_obs_table, create_lm_state, lm_run

    from drivers.ba import _pose_gap, bundle_config, change_gap

    bcfg = bundle_config("plainref", sess.cfg)
    builders = {"problem_recent": problem_recent, "problem_all": problem_all}
    mismatch, gap, change, pose, n_ba, n_wb = 0, 0.0, 0.0, 0.0, 0, 0
    last = {len(sess.bas) - 1} if sess.bas else set()
    with precision(False):
        for i in sorted(set(sess.ba_pool) | last):
            b = sess.bas[i]
            if b.first is None:
                continue
            prob_p = to_reference(b.prob)
            P, K = prob_p.points.shape[0], prob_p.m_valid.shape[0]
            prob = attach_obs_table(compact_problem(
                builders[b.kind](to_reference(b.start), *b.args), max_points=P, max_meas=K),
                prob_p.obs_idx.shape[1])
            fgap, where, differ, fields = split_gaps(tree_gaps(prob_p, prob))
            st0 = create_lm_state(prob, bcfg)
            ref = lm_run(prob, st0, sess.cams_r, b.first[2], bcfg, fixed_b=True)
            got = to_reference(b.first[1])
            _, look = change_gap(*movable(prob, st0, got, ref))
            cgap = pose_change_gap(look)
            pgap = _pose_gap(got, ref)
            if b.last is not None:
                ref = lm_run(prob, to_reference(b.last[0]), sess.cams_r, b.last[2], bcfg,
                             fixed_b=True)
                pgap = max(pgap, _pose_gap(to_reference(b.last[1]), ref))
            mismatch, gap = mismatch + differ, max(gap, fgap)
            change, pose, n_ba = max(change, cgap), max(pose, pgap), n_ba + 1
            print(f"map: BA {i} ({b.kind}, {int(prob.m_valid.sum())} measurements, "
                  f"{1 + (b.last is not None)} chunks judged): problem's largest float gap "
                  f"{fgap} ({where}), differing elements {fields or 0}; first chunk's change "
                  f"(program, reference) {look}, gap {cgap}; pose gap {pgap}", file=sys.stderr)
            b.start = b.prob = b.first = b.last = None
        last = {len(sess.wbs) - 1} if sess.wbs else set()
        for i in sorted(set(sess.wb_pool) | last):
            w = sess.wbs[i]
            ms = writeback(to_reference(w.before), to_reference(w.prob), to_reference(w.st))
            fgap, where, differ, fields = split_gaps(tree_gaps(to_reference(w.after), ms))
            mismatch, gap, n_wb = mismatch + differ, max(gap, fgap), n_wb + 1
            print(f"map: writeback {i}: largest float gap {fgap} ({where}); differing "
                  f"elements {fields or 0}", file=sys.stderr)
            w.before = w.prob = w.st = w.after = None
    return mismatch, gap, change, pose, n_ba, n_wb


def judge(sess: Session, limits: dict) -> dict:
    """Every number compared, with its limit: {name: (value, limit, passes)}."""
    t0 = time.perf_counter()
    ms_gap, ms_where, ms_mismatch, ms_fields = split_gaps(
        tree_gaps(to_reference(sess.ms0), to_host(reference_map(sess))))
    print(f"map: start map: largest float gap {ms_gap} ({ms_where}); differing elements "
          f"{ms_fields or 0}", file=sys.stderr)
    poses, covs, founds = [], [], []
    lost_mismatch = missing = 0
    for fid0 in sess.judged:
        ts, ms = sess.snaps[fid0]
        ref, _, _ = reference_track(sess, fid0, to_reference(ts), to_reference(ms))
        for j, (pose_r, cov_r, found_r, lost_r) in enumerate(ref):
            got = sess.infos.get(fid0 + j)
            if got is None:
                missing += 1
                continue
            pose, cov, found, lost = got
            poses.append(float(np.abs(pose - pose_r).max()))
            covs.append(float(np.abs(cov - cov_r).max() / max(np.abs(cov_r).max(), 1e-30)))
            founds.append(abs(found - found_r) / max(found_r, 1))
            lost_mismatch += int(lost != lost_r)
    sess.snaps.clear()
    med = lambda v: float(np.median(v)) if v else 0.0  # noqa: E731
    add_mismatch = judge_adds(sess)
    int_mismatch, int_gap, int_pts_gap, n_int = judge_integrations(sess)
    ba_mismatch, ba_gap, ba_change, ba_pose, n_ba, n_wb = judge_ba(sess)
    win = [f for f in sess.window_fids if f in sess.infos]
    max_err = max((pose_error(sess.infos[f][0], sess.gt[f % sess.n]) for f in win),
                  default=float("inf"))
    lost_frames = sum(bool(sess.infos[f][3]) for f in win)
    rate = 100.0 * sess.accepted / max(len(win), 1)
    vals = {"start_map_gap": ms_gap, "start_map_mismatch": ms_mismatch,
            "pose_gap_median": med(poses), "cov_gap_median": med(covs),
            "found_frames_share": sum(f > 0 for f in founds) / max(len(founds), 1),
            "pose_gap": max(poses, default=0.0), "cov_gap": max(covs, default=0.0),
            "found_gap": max(founds, default=0.0), "lost_mismatch": lost_mismatch,
            "missing_frames": missing, "add_mismatch": add_mismatch,
            "integrate_mismatch": int_mismatch, "integrate_gap": int_gap,
            "integrate_points_gap": int_pts_gap, "ba_mismatch": ba_mismatch, "ba_gap": ba_gap,
            "ba_change_gap": ba_change, "ba_pose_gap": ba_pose, "lost_frames": lost_frames,
            "max_pose_err": max_err}
    out = {k: (v, limits[k], v <= limits[k]) for k, v in vals.items() if k in limits}
    for k, v in vals.items():
        if k not in out:
            print(f"reading {k}: {v} (not compared)", file=sys.stderr)
    jm, B = sess.mix["judge"], sess.mix["batch"]
    n_judged = len(sess.judged) * B - missing
    out["judged_frames"] = (n_judged, jm["batches"] * B, n_judged >= jm["batches"] * B)
    out["judged_integrations"] = (n_int, jm["integrations"], n_int >= jm["integrations"])
    out["judged_bas"] = (n_ba, jm["bas"], n_ba >= jm["bas"])
    out["judged_writebacks"] = (n_wb, jm["writebacks"], n_wb >= jm["writebacks"])
    floor = limits["mkfs_per_100_frames"]
    out["mkfs_per_100_frames"] = (rate, floor, rate >= floor)
    print(f"map: judged in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return out


# -- faults planted under the timed path (faults.py) --------------------------

def integrate_unchanged():
    """Integration returns the map it was given, as it was."""
    from mcptam_tpu_torch.map.state import clone_tree as program_clone
    from mcptam_tpu_torch.system import mapmaker

    orig = mapmaker.integrate_mkf_device

    def unchanged(ms, *a, **k):
        kept = program_clone(ms)
        out = orig(ms, *a, **k)
        return (kept, *out[1:])

    return patch(mapmaker, "integrate_mkf_device", unchanged)


def half_epipolar():
    """Every other candidate of the epipolar passes left out."""
    from mcptam_tpu_torch.map import mapmaker_core

    orig = mapmaker_core.create_epipolar_points

    def half(ms, cams, *a, want, **k):
        keep = torch.arange(want.shape[0], device=want.device) % 2 == 0
        return orig(ms, cams, *a, want=want & keep, **k)

    return patch(mapmaker_core, "create_epipolar_points", half)


def point_moved():
    """One point that integration makes moved a millimetre."""
    from mcptam_tpu_torch.system import mapmaker

    orig = mapmaker.integrate_mkf_device

    def moved(ms, *a, **k):
        was = ms.points.valid.clone()
        out = orig(ms, *a, **k)
        new = out[0].points.valid & ~was
        first = torch.argmax(new.to(torch.int32))
        out[0].points.pos_w[first] += 1e-3 * new[first].to(out[0].points.pos_w.dtype)
        return out

    return patch(mapmaker, "integrate_mkf_device", moved)


def adds_dropped():
    """Every other keyframe the add rule wants is not queued."""
    from mcptam_tpu_torch.system import mapmaker

    orig = mapmaker.MapMaker.add_mkf
    n = [0]

    def add_mkf(self, *a, **k):
        n[0] += 1
        if n[0] % 2 == 0:
            return None
        return orig(self, *a, **k)

    return patch(mapmaker.MapMaker, "add_mkf", add_mkf)


def ba_unchanged():
    """Each BA chunk returns the state it was given: bundle adjustment
    leaves the map as it was."""
    from mcptam_tpu_torch.system import mapmaker

    orig = mapmaker.lm_run

    def unchanged(prob, st, *a, **k):
        kept = clone_tree(st)
        orig(prob, st, *a, **k)
        return kept

    return patch(mapmaker, "lm_run", unchanged)


def ba_half_batch():
    """Half the measurements left out of every BA chunk."""
    from mcptam_tpu_torch.system import mapmaker

    orig = mapmaker.lm_run

    def half(prob, st, *a, **k):
        keep = torch.arange(prob.m_valid.shape[0], device=prob.m_valid.device) % 2 == 0
        return orig(prob.replace(m_valid=prob.m_valid & keep), st, *a, **k)

    return patch(mapmaker, "lm_run", half)


def writeback_skipped():
    """A finished or preempted BA's result is not written into the map."""
    from mcptam_tpu_torch.system import mapmaker

    return patch(mapmaker, "writeback", lambda ms, prob, st: ms)


FAULTS = {"integrate_unchanged": integrate_unchanged, "half_epipolar": half_epipolar,
          "point_moved": point_moved, "adds_dropped": adds_dropped,
          "ba_unchanged": ba_unchanged, "ba_half_batch": ba_half_batch,
          "writeback_skipped": writeback_skipped}
