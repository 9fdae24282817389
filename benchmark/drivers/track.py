"""The tracking mix: a closed loop over ``System.process_frames``.

Set-up renders the mix's closed trajectory on the device from the seed
(the texture's seed and the trajectory's phase; every seed renders the
same poses in another order), builds the ground-truth map through the
program's own API, and warms the pipeline up with the mix's first batches.
The map-maker ticks every ``tick_every``-th batch; 0 never ticks it.  The
window hands in B frames a call, looping over the trajectory, and counts
the FrameInfos the calls return.

Correct: the program's start map (a host copy taken as it is built) is
held against the map the plain reference builds from the same rendered
keyframe, every field: integer, flag and pixel fields exact, float fields
by their largest gap.  The program's tracker state and map are copied just
before each batch is handed in, and kept for a sample of the window's
batches drawn from the seed and for its last batch; after the window the
plain reference tracks each kept batch's frames from that copy, and the
program's pose, covariance, found count and lost flag are held against
it.  The ground-truth gates (mean found, pose error against the rendered
trajectory) stand beside it.
"""

from __future__ import annotations

import dataclasses
import random
import sys
import time

import numpy as np
import torch

from faults import patch
from harness.convert import clone_tree, to_host, to_program, to_reference, tree_gaps

UNIT = "frames"
# window calls of a reading for the limits (control.py)
CONTROL_CALLS = lambda mix: 12  # noqa: E731


def tangent(i: int, n: int, amp) -> list:
    """Pose i of the closed trajectory of n poses (the repository's
    benchmark trajectory at its amplitudes)."""
    a = 2.0 * np.pi * i / n
    return [amp[0] * np.sin(a), -amp[1] * np.sin(2 * a + 0.7), amp[2] * np.cos(a),
            amp[3] * np.sin(a + 1.3), amp[4] * np.cos(2 * a), amp[5] * np.sin(3 * a + 0.5)]


def seed_params(seed: int, mix: dict) -> tuple:
    """(texture seed, trajectory phase) of a run seed."""
    rng = random.Random(seed)
    tex = mix["texture"]["base"] + mix["texture"]["span"] * rng.random()
    return tex, rng.randrange(mix["trajectory"]["n_poses"])


@dataclasses.dataclass
class Session:
    cfg: dict
    mix: dict
    seed: int
    dev: torch.device
    sync: object
    frames: torch.Tensor          # (n, C, H, W) uint8, frame i of the loop
    gt: list                      # ground-truth (R, t) of frame i
    cams_r: object                # the reference's rig, the inputs of both sides
    cfb_r: object
    tex: float
    system: object = None
    ms0: object = None            # the start map, a host copy
    left_out: int = 0             # frames returned in the profiled slice (no latency)
    next_fid: int = 0
    snaps: dict = dataclasses.field(default_factory=dict)   # fid0 -> (ts, ms)
    infos: dict = dataclasses.field(default_factory=dict)   # fid -> (pose, cov, found, lost)
    window_fids: list = dataclasses.field(default_factory=list)
    judged: list = dataclasses.field(default_factory=list)


def make_inputs(cfg: dict, mix: dict, seed: int, dev):
    """The rig (the reference's classes) and the rendered loop, from the seed."""
    from plainref.core.se3 import SE3
    from plainref.io.synthetic import make_rig, render_rig

    rig, traj = cfg["rig"], mix["trajectory"]
    C, H, W = rig["n_cams"], rig["height"], rig["width"]
    tex, phase = seed_params(seed, mix)
    n = traj["n_poses"]
    cams_r, cfb_r = make_rig(C, H, W, spread_deg=rig["spread_deg"], device=dev)
    frames = torch.empty((n, C, H, W), dtype=torch.uint8, device=dev)
    gt = []
    for i in range(n):
        pose = SE3.exp(torch.tensor(tangent((i + phase) % n, n, traj["amplitude"]),
                                    dtype=torch.float32, device=dev))
        gt.append((pose.R.cpu().numpy(), pose.t.cpu().numpy()))
        frames[i] = torch.clamp(render_rig(cams_r, cfb_r, pose, tex, H, W), 0, 255).to(torch.uint8)
    return cams_r, cfb_r, frames, gt, tex


def tracker_config(pkg: str, cfg: dict):
    import importlib
    c = importlib.import_module(f"{pkg}.config")
    return (c.TrackerConfig(**cfg["tracker"]), c.MapMakerConfig(**cfg["mapmaker"]))


def setup(cfg: dict, mix: dict, seed: int, dev, sync) -> Session:
    """Inputs from the seed, the program's System over the ground-truth
    map, and the warm-up batches."""
    from mcptam_tpu_torch.io.synthetic import build_groundtruth_map, make_sbi_cams
    from mcptam_tpu_torch.system.system import System

    t0 = time.perf_counter()
    cams_r, cfb_r, frames, gt, tex = make_inputs(cfg, mix, seed, dev)
    sync()
    t_inputs = time.perf_counter() - t0
    rig, cap = cfg["rig"], cfg["capacity"]
    H, W = rig["height"], rig["width"]
    cams, cfb = to_program(cams_r), to_program(cfb_r)
    tcfg, mcfg = tracker_config("mcptam_tpu_torch", cfg)
    ms, _ = build_groundtruth_map(cams, cfb, H, W, seed=tex,
                                  n_per_level=mix["map"]["n_per_level"], **cap)
    ms0 = to_host(ms)
    sys_ = System(cams, cfb, make_sbi_cams(cams, H, W), H, W, tcfg=tcfg, mcfg=mcfg,
                  pipeline_depth=mix["pipeline_depth"], **cap)
    sys_.ms, sys_.initialized = ms, True
    sys_.vars["AddingMKFs"] = bool(mix["adding_mkfs"])
    sys_.tick_every = int(mix["tick_every"]) or sys.maxsize
    sess = Session(cfg, mix, seed, dev, sync, frames, gt, cams_r, cfb_r, tex, sys_, ms0=ms0)
    sync()
    t_map = time.perf_counter() - t0 - t_inputs
    for _ in range(mix["warmup_batches"]):
        _call(sess, None)
    sync()
    print(f"track: set-up s: inputs {t_inputs:.2f}, map and System {t_map:.2f}, warm-up "
          f"{time.perf_counter() - t0 - t_inputs - t_map:.2f}", file=sys.stderr)
    return sess


def _call(sess: Session, lat: list | None, snap: bool = False, timed: bool = True) -> int:
    """Hand in the next B frames; record the returned FrameInfos (and with
    ``lat`` the frames as the window's, and while ``timed`` each returned
    frame's latency).  Returns the frames returned."""
    B, n = sess.mix["batch"], sess.frames.shape[0]
    fid0 = sess.next_fid
    if snap:
        sess.snaps[fid0] = (clone_tree(sess.system.ts), clone_tree(sess.system.ms))
    s = fid0 % n
    t_in = time.perf_counter()
    out = sess.system.process_frames(sess.frames[s:s + B])
    t_out = time.perf_counter()
    sess.next_fid += B
    _keep(sess, out)
    if lat is not None:
        sess.window_fids.extend(range(fid0, fid0 + B))
        sess.t_in.update({f: t_in for f in range(fid0, fid0 + B)})
        back = [t_out - sess.t_in[i.frame_id] for i in out if i.frame_id in sess.t_in]
        if timed:
            lat.extend(back)
        else:
            sess.left_out += len(back)
    return len(out)


def _keep(sess: Session, infos):
    for i in infos:
        sess.infos[i.frame_id] = (i.pose, i.cov_raw, i.n_found, i.lost)


def window(sess: Session, seconds: float, rec, hooks, trace: bool, max_calls: int = 0):
    """The measured window.  With ``trace`` the spans are on for ``seconds``,
    and then ``profile_batches`` more calls run under the profiler (spans
    off, launch shapes noted); the window ends with them.  The latencies are
    those of the frames returned while the spans are on: a profiled call's
    time holds the profiler's start, so its frames are left out."""
    from harness.trace import profile_slice, summarize

    mix = sess.mix
    if mix["trajectory"]["n_poses"] % mix["batch"] or sess.next_fid % mix["batch"]:
        raise ValueError("the trajectory must hold whole batches")
    jm = mix["judge"]
    rng = random.Random(sess.seed ^ 0x5EED)
    sess.t_in, lat = {}, []
    returned, calls, pool, last = 0, 0, [], None
    diag = []          # the seconds of each call

    def one(timed=True):
        """A call; the state it starts from is copied, and the copy kept
        while its batch is in the sample (a reservoir of the window's
        batches drawn from the seed) or is the newest."""
        nonlocal returned, calls, last
        fid0 = sess.next_fid
        t_call = time.perf_counter()
        n_out = _call(sess, lat, snap=True, timed=timed)
        diag.append(round(time.perf_counter() - t_call, 3))
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

    t0 = time.perf_counter()
    hooks.spans_on = trace
    while time.perf_counter() - t0 < seconds and not (max_calls and calls >= max_calls):
        one()
    hooks.spans_on = False
    if trace:
        hooks.launches_on = True
        _, events, wall, read_s = profile_slice(
            lambda: [one(timed=False) for _ in range(mix["profile_batches"])], sess.sync)
        hooks.launches_on = False
        rec.slice = summarize(events, wall, mix["profile_batches"] * mix["batch"], UNIT, read_s)
        print(f"track: latencies of {len(lat)} frames returned with the spans on; "
              f"{sess.left_out} returned in the profiled slice left out", file=sys.stderr)
    rec.window_s = time.perf_counter() - t0 - (rec.slice or {}).get("read_s", 0.0)
    sess.judged = sorted(set(pool) | ({last} if last is not None else set()))
    rec.units, rec.attempted, rec.latencies = returned, calls * mix["batch"], lat
    _keep(sess, sess.system.flush_pipeline())
    sess.sync()
    print(f"track: seconds of each call: {diag}", file=sys.stderr)
    rec.failed = sum(bool(sess.infos[f][3]) for f in sess.window_fids if f in sess.infos)


def release(sess: Session):
    """Drop the program's state; the copies the judge needs stay."""
    sess.system = None


def pose_error(info_pose: np.ndarray, gt) -> float:
    Rg, tg = gt
    Re, te = info_pose[:, :3], info_pose[:, 3]
    dR = Re @ Rg.T
    ang = np.arccos(np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0))
    return float(np.hypot(ang, np.linalg.norm(te - dR @ tg)))


def reference_track(sess: Session, fid0: int, ts, ms, tf32: bool = False) -> tuple:
    """The plain reference tracking frames fid0 .. fid0 + B - 1 from the
    given state (reference classes): ([(pose (3,4), cov, found, lost)],
    the state after them)."""
    from plainref.io.synthetic import make_sbi_cams
    from plainref.map.keyframe import make_frame_features
    from plainref.tracker.tracker import apply_tracker_point_stats, track_frame

    rig = sess.cfg["rig"]
    tcfg, mcfg = tracker_config("plainref", sess.cfg)
    cams_sbi = make_sbi_cams(sess.cams_r, rig["height"], rig["width"])
    n, out = sess.frames.shape[0], []
    active = torch.ones(rig["n_cams"], dtype=torch.bool, device=sess.dev)
    with precision(tf32):
        for f in range(fid0, fid0 + sess.mix["batch"]):
            feats = make_frame_features(sess.frames[f % n])
            ts, res = track_frame(ts, ms, sess.cams_r, cams_sbi, feats, tcfg, cam_active=active)
            ms = apply_tracker_point_stats(ms, res, mcfg.min_outliers, mcfg.outlier_multiplier,
                                           enable=~res.lost)
            pose = torch.cat([res.pose.R, res.pose.t[:, None]], 1)
            out.append((pose.cpu().numpy(), res.cov.cpu().numpy(),
                        int(res.tot_found), bool(res.lost)))
    return out, ts, ms


class precision:
    """TF32 on inside (the control's precision), off outside."""

    def __init__(self, tf32: bool):
        self.tf32 = tf32

    def __enter__(self):
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def reference_map(sess: Session, tf32: bool = False):
    """The start map as the plain reference builds it from the session's
    rendered keyframe."""
    from plainref.io.synthetic import build_groundtruth_map

    rig, cap = sess.cfg["rig"], sess.cfg["capacity"]
    with precision(tf32):
        ms, _ = build_groundtruth_map(sess.cams_r, sess.cfb_r, rig["height"], rig["width"],
                                      seed=sess.tex,
                                      n_per_level=sess.mix["map"]["n_per_level"], **cap)
    return ms


def map_gaps(sess: Session) -> tuple:
    """(largest float gap, count of differing integer, flag and pixel
    elements) of the program's start map against the reference's."""
    gaps = tree_gaps(to_reference(sess.ms0), to_host(reference_map(sess)))
    floats = {k: v for k, v in gaps.items() if isinstance(v, float)}
    exact = {k: v for k, v in gaps.items() if not isinstance(v, float)}
    worst = max(floats, key=floats.get)
    differ = {k: v for k, v in exact.items() if v}
    print(f"track: start map: largest float gap {floats[worst]} ({worst}); differing "
          f"elements {differ or 0}", file=sys.stderr)
    return floats[worst], sum(exact.values())


def judge(sess: Session, limits: dict) -> dict:
    """Every number compared, with its limit: {name: (value, limit, passes)}."""
    start_map_gap, start_map_mismatch = map_gaps(sess)
    pose_gap = cov_gap = found_gap = 0.0
    lost_mismatch = 0
    missing = 0
    for fid0 in sess.judged:
        ts, ms = sess.snaps[fid0]
        ref, _, _ = reference_track(sess, fid0, to_reference(ts), to_reference(ms))
        for j, (pose_r, cov_r, found_r, lost_r) in enumerate(ref):
            got = sess.infos.get(fid0 + j)
            if got is None:
                missing += 1
                continue
            pose, cov, found, lost = got
            pose_gap = max(pose_gap, float(np.abs(pose - pose_r).max()))
            cov_gap = max(cov_gap, float(np.abs(cov - cov_r).max()
                                         / max(np.abs(cov_r).max(), 1e-30)))
            found_gap = max(found_gap, abs(found - found_r) / max(found_r, 1))
            lost_mismatch += int(lost != lost_r)
    win = [f for f in sess.window_fids if f in sess.infos]
    n = sess.frames.shape[0]
    mean_found = float(np.mean([sess.infos[f][2] for f in win])) if win else 0.0
    max_err = max((pose_error(sess.infos[f][0], sess.gt[f % n]) for f in win),
                  default=float("inf"))
    g = sess.mix["gates"]
    vals = {"start_map_gap": start_map_gap, "start_map_mismatch": start_map_mismatch,
            "pose_gap": pose_gap, "cov_gap": cov_gap, "found_gap": found_gap,
            "lost_mismatch": lost_mismatch, "missing_frames": missing}
    out = {k: (v, limits[k], v <= limits[k]) for k, v in vals.items() if k in limits}
    n_judged = len(sess.judged) * sess.mix["batch"] - missing
    want = sess.mix["judge"]["batches"] * sess.mix["batch"]
    out["judged_frames"] = (n_judged, want, n_judged >= want)
    out["mean_found"] = (mean_found, g["min_mean_found"], mean_found >= g["min_mean_found"])
    out["max_pose_err"] = (max_err, g["max_pose_err"], max_err < g["max_pose_err"])
    return out


@dataclasses.dataclass
class RefInfo:
    """The reference's answer for a frame, in FrameInfo's names."""
    pose: np.ndarray
    cov_raw: np.ndarray
    n_found: int
    lost: bool
    frame_id: int


class ReferenceSystem:
    """The plain reference in the program's place (the precision control):
    process_frames tracks each frame at once, nothing pipelined."""

    def __init__(self, sess: Session, tf32: bool):
        from plainref.tracker.tracker import create_tracker_state

        self.sess, self.tf32 = sess, tf32
        self.ms = reference_map(sess, tf32)
        self.ts = create_tracker_state(sess.cfg["rig"]["n_cams"], sess.dev)
        self.fid = 0

    def process_frames(self, batch) -> list:
        out, self.ts, self.ms = reference_track(self.sess, self.fid, self.ts, self.ms, self.tf32)
        infos = [RefInfo(*o, self.fid + j) for j, o in enumerate(out)]
        self.fid += len(out)
        return infos

    def flush_pipeline(self) -> list:
        return []


def control_setup(cfg: dict, mix: dict, seed: int, dev, sync) -> Session:
    """The control's session: the same inputs, the reference in TF32 in the
    program's place, warmed up as the program is."""
    cams_r, cfb_r, frames, gt, tex = make_inputs(cfg, mix, seed, dev)
    sess = Session(cfg, mix, seed, dev, sync, frames, gt, cams_r, cfb_r, tex)
    sess.system = ReferenceSystem(sess, tf32=True)
    sess.ms0 = to_host(sess.system.ms)
    for _ in range(mix["warmup_batches"]):
        _call(sess, None)
    return sess


# -- faults planted under the timed path (faults.py) --------------------------

def state_unchanged():
    """The tracking step returns its input state and pose."""
    from mcptam_tpu_torch.system import system

    orig = system.track_frame

    def tracked(ts, ms, *a, **k):
        _, res = orig(ts, ms, *a, **k)
        return ts, dataclasses.replace(res, pose=ts.pose)

    return patch(system, "track_frame", tracked)


def answer_altered():
    """The pose moved a millimetre where the tracking step makes it."""
    from mcptam_tpu_torch.system import system

    orig = system.track_frame

    def tracked(ts, ms, *a, **k):
        ts2, res = orig(ts, ms, *a, **k)
        pose = dataclasses.replace(res.pose, t=res.pose.t + 1e-3)
        return ts2, dataclasses.replace(res, pose=pose)

    return patch(system, "track_frame", tracked)


def half_batch():
    """Every other frame of a batch tracked, its result standing for the
    one left out."""
    from mcptam_tpu_torch.system import system

    orig = system.System._batch_step

    def half(self, ts, ms, images_b, cam_active, queue_poses=None):
        ts, ms, rows, results = orig(self, ts, ms, images_b[::2], cam_active, queue_poses)
        return (ts, ms, rows.repeat_interleave(2, 0)[: images_b.shape[0]],
                [r for r in results for _ in range(2)][: images_b.shape[0]])

    return patch(system.System, "_batch_step", half)


def map_moved():
    """One point of the start map moved a millimetre as it is built."""
    from mcptam_tpu_torch.io import synthetic

    orig = synthetic.build_groundtruth_map

    def moved(*a, **k):
        ms, feats = orig(*a, **k)
        ms.points.pos_w[0] += 1e-3
        return ms, feats

    return patch(synthetic, "build_groundtruth_map", moved)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered, "map_moved": map_moved}
