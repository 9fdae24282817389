#!/usr/bin/env python3
"""Where the PyTorch port's tracking slice, map-maker and live session
spend their time on one GPU.

    python3 scripts/profile_torch_slice.py [--frames 16] [--stage all|live]

Builds the scene of chip_smoke.py (4-camera 480x640 rig, ground-truth map
with 2048 point slots, default TrackerConfig) on the card, warms the
System over one batch, then reports:
  * per-stage times of single frames, each stage ended by a device
    synchronise (features, sbi, motion, pvs, coarse, fine, pose,
    finalize, stats + add heuristic);
  * a torch.profiler window over --frames frames of process_frames:
    the top operators by device time, device kernels launched per frame
    (and how many of them are the FAST front-end's), and the device-busy
    share of the window (summed kernel time over wall time; one stream,
    so kernels do not overlap);
  * the map-maker: chip_smoke.py's mapping warm-up (the rig walks 0.3 m
    sideways and back, keyframes are added and integrated) with every
    scheduler tick timed to a device synchronise and sorted by what it
    did (integrate, BA start, BA chunk, BA finish, idle GC and refinds);
    local BA runs from 2 MKFs here (recent_min_size 2; the default 8
    would need a longer walk);
  * a profiler window over 10 LM steps of chip_smoke.py's LM problem (16
    poses, 2048 points, 8192 measurements): device ops per LM step and
    the device-busy share;
  * the live session of chip_smoke.py's phase 7 (process_frame from an
    empty map, static mask and glare masking, the turning warm-up, the
    forced loss and the return), every section of a frame timed to a
    device synchronise (features, bootstrap, tracker step, candidate
    filter, relocalisation attempt, map-maker tick), then a profiler
    window over --frames frames of process_frame.  ``--stage live`` runs
    only this part.
Needs a CUDA device; prints the card and its power limit beside every
number.
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (scene constants and trajectory)


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--stage", choices=("all", "live"), default="all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_slice: needs a CUDA device", file=sys.stderr)
        return 1

    from mcptam_tpu_torch.config import TrackerConfig
    from mcptam_tpu_torch.core.se3 import SE3
    from mcptam_tpu_torch.io.synthetic import (
        build_groundtruth_map, make_rig, make_sbi_cams, render_rig,
    )
    from mcptam_tpu_torch.map.keyframe import make_frame_features
    from mcptam_tpu_torch.map.mapmaker_core import need_new_mkf
    from mcptam_tpu_torch.system.system import System
    from mcptam_tpu_torch.tracker import tracker as T

    card = cs.card_line()
    dev = torch.device("cuda:0")
    cams, cfb = make_rig(cs.C, cs.H, cs.W, spread_deg=25.0, device=dev)
    cams_sbi = make_sbi_cams(cams, cs.H, cs.W)
    if args.stage == "live":
        return profile_live(cams, cfb, cams_sbi, card, args.frames)
    ms, _ = build_groundtruth_map(
        cams, cfb, cs.H, cs.W, n_per_level=cs.N_PER_LEVEL,
        max_points=cs.MAX_POINTS, max_mkfs=cs.MAX_MKFS, max_meas=cs.MAX_MEAS)
    frames = [torch.clamp(render_rig(
        cams, cfb, SE3.exp(torch.tensor(cs.traj_tangent(i), dtype=torch.float32,
                                        device=dev)),
        cs.SEED, cs.H, cs.W), 0, 255).to(torch.uint8)
        for i in range(cs.N_POSES)]
    tcfg = TrackerConfig()
    sys_ = System(cams, cfb, cams_sbi, cs.H, cs.W, tcfg=tcfg,
                  max_points=cs.MAX_POINTS, max_mkfs=cs.MAX_MKFS,
                  max_meas=cs.MAX_MEAS)
    sys_.ms, sys_.initialized = ms, True
    sys_.vars["AddingMKFs"] = False
    sys_.process_frames(torch.stack(frames[:cs.B]))   # warm-up batch
    torch.cuda.synchronize()

    # ---- per-stage times, one synchronise per stage
    stages = {}

    def lap(name, t0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stages.setdefault(name, []).append((t1 - t0) * 1e3)
        return t1

    ts, ca = sys_.ts, torch.ones(cs.C, dtype=torch.bool, device=dev)
    for i in range(cs.B, 2 * cs.B):
        t0 = time.perf_counter()
        feats = make_frame_features(frames[i])
        t0 = lap("features", t0)
        rot, have = T._stage_sbi(ts, feats, cams_sbi, ms.cam_from_base, tcfg, ca)
        t0 = lap("sbi", t0)
        pred = T._stage_motion(ts, rot, have)
        t0 = lap("motion", t0)
        pvs = T._stage_pvs(ms, cams, pred, ca)
        t0 = lap("pvs", t0)
        pac, do_c = T._stage_coarse(ms, cams, feats, pvs, pred, tcfg)
        t0 = lap("coarse", t0)
        fine = T._stage_fine(ms, cams, feats, pvs, pac, do_c, tcfg)
        t0 = lap("fine", t0)
        pose, cov, outl = T._stage_pose(ms, cams, pac, fine, tcfg)
        t0 = lap("pose", t0)
        ts, res = T._stage_finalize(ts, ms, feats, pose, cov, fine, outl, rot,
                                    tcfg, ca)
        t0 = lap("finalize", t0)
        T.apply_tracker_point_stats(ms, res, enable=~res.lost)
        need_new_mkf(ms, res.pose, torch.mean(res.mean_depth))
        lap("stats+add", t0)
    total = sum(np.mean(v) for v in stages.values())
    print(f"per-stage ms/frame (mean of {cs.B} frames, synchronised) on {card}:")
    for name, v in stages.items():
        print(f"  {name:10s} {np.mean(v):9.3f} ms  {100 * np.mean(v) / total:5.1f}%")
    print(f"  {'total':10s} {total:9.3f} ms")

    # ---- profiler window over process_frames
    batches = [torch.stack(frames[j:j + cs.B])
               for j in range(2 * cs.B, 2 * cs.B + args.frames, cs.B)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            sys_.process_frames(b)
        sys_.flush_pipeline()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_frames = len(batches) * cs.B
    events = prof.key_averages()
    # device-side rows (kernels, memcpy, memset); the CPU-op rows carry the
    # same time again as their children's
    on_dev = [e for e in events if e.device_type.name == "CUDA"]
    dev_us = sum(e.self_device_time_total for e in on_dev)
    kernels = sum(e.count for e in on_dev)
    print(f"profiled window: {n_frames} frames in {wall * 1e3:.1f} ms wall "
          f"({n_frames / wall:.2f} frames/s under the profiler) on {card}")
    print(f"device busy {dev_us / 1e3:.1f} ms = {100 * dev_us / 1e6 / wall:.1f}% "
          f"of the window; {kernels / n_frames:.0f} device ops per frame; "
          f"{_fast_ops(on_dev) / n_frames:.2f} of them the FAST front-end's")
    print(events.table(sort_by="self_device_time_total", row_limit=30,
                       max_name_column_width=60))
    print(events.table(sort_by="self_cpu_time_total", row_limit=15,
                       max_name_column_width=60))

    profile_mapmaker(cams, cfb, cams_sbi, card)
    profile_lm(dev, card)
    return profile_live(cams, cfb, cams_sbi, card, args.frames)


def _fast_ops(on_dev) -> int:
    """Device ops of the FAST front-end (csrc/fast.cu's kernels)."""
    return sum(e.count for e in on_dev if "fast_levels_kernel" in e.key)


def _device_share(prof, wall):
    """(device-busy ms, device ops) of a profiler window."""
    on_dev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    return (sum(e.self_device_time_total for e in on_dev) / 1e3,
            sum(e.count for e in on_dev))


def profile_mapmaker(cams, cfb, cams_sbi, card):
    """Every map-maker tick of the mapping warm-up, timed and classified."""
    import torch
    from mcptam_tpu_torch.config import BundleConfig, MapMakerConfig, TrackerConfig
    from mcptam_tpu_torch.core.se3 import SE3
    from mcptam_tpu_torch.io.synthetic import build_groundtruth_map, render_rig
    from mcptam_tpu_torch.system.mapmaker import MM_RUNNING, MapMaker
    from mcptam_tpu_torch.system.system import System

    dev = cfb.t.device
    ms, _ = build_groundtruth_map(
        cams, cfb, cs.H, cs.W, n_per_level=cs.N_PER_LEVEL,
        max_points=cs.MAX_POINTS, max_mkfs=cs.MAX_MKFS, max_meas=cs.MAX_MEAS)
    warm = [torch.clamp(render_rig(cams, cfb, SE3.exp(torch.tensor(
        cs.excursion_tangent(i), dtype=torch.float32, device=dev)), cs.SEED,
        cs.H, cs.W), 0, 255).to(torch.uint8) for i in range(cs.N_WARMUP)]
    mm = MapMaker(cams=cams, mcfg=MapMakerConfig(),
                  bcfg=BundleConfig(recent_min_size=2), ba_chunk=cs.BA_CHUNK)
    sys_ = System(cams, cfb, cams_sbi, cs.H, cs.W, tcfg=TrackerConfig(),
                  max_points=cs.MAX_POINTS, max_mkfs=cs.MAX_MKFS,
                  max_meas=cs.MAX_MEAS, mapmaker=mm, pipeline_depth=2 * cs.B)
    sys_.ms, sys_.initialized = ms, True
    mm.state = MM_RUNNING
    sys_.tick_every = cs.TICK_EVERY

    ticks, nested = {}, []
    tick = mm._tick

    def timed_tick(ms_):
        if nested:                       # _tick's own retry: part of the outer tick
            return tick(ms_)
        nested.append(1)
        kind0, queued = mm._ba_kind, bool(mm.queue)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tick(ms_)
        torch.cuda.synchronize()
        nested.clear()
        dt = (time.perf_counter() - t0) * 1e3
        kind1 = mm._ba_kind
        if queued:
            name = "integrate MKF"
        elif kind0 == "none" and kind1 != "none":
            name = f"{kind1} BA start + chunk"
        elif kind0 != "none" and kind1 == kind0:
            name = f"{kind0} BA chunk"
        elif kind0 != "none":
            name = f"{kind0} BA chunk + finish"
        elif mm._idle_ticks % 20 in (0, 10):
            name = "idle GC + refind sweep"
        else:
            name = "idle GC"
        ticks.setdefault(name, []).append(dt)
        return out

    mm._tick = timed_tick
    t0 = time.perf_counter()
    for i in range(0, cs.N_WARMUP, cs.B):
        sys_.process_frames(torch.stack(warm[i:i + cs.B]))
    sys_.flush_pipeline()
    for _ in range(120):                 # run the BA work to its end
        if (not mm.queue and mm._ba_kind == "none" and mm._local_done
                and mm._global_done):
            break
        sys_.ms = mm.step(sys_.ms)
    for _ in range(20):                  # idle: GC, one general refind sweep
        sys_.ms = mm.step(sys_.ms)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"map-maker ticks of the mapping warm-up ({cs.N_WARMUP} frames, BA to "
          f"its end, 20 idle ticks; {wall:.2f} s wall; BA runs {mm.ba_log}) on {card}:")
    for name, v in sorted(ticks.items()):
        print(f"  {name:28s} n={len(v):3d}  mean {np.mean(v):9.3f} ms  "
              f"max {np.max(v):9.3f} ms")

    # device-busy share of the mapping slice: a window of process_frames
    # with the map-maker ticking (BA under way after an on_map_changed)
    mm._tick = tick
    mm.on_map_changed()
    batches = [torch.stack([warm[(j + k) % cs.N_WARMUP] for k in range(cs.B)])
               for j in range(0, 32, cs.B)]
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            sys_.process_frames(b)
        sys_.flush_pipeline()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, ops = _device_share(prof, wall)
    print(f"mapping window: {len(batches) * cs.B} frames with the map-maker ticking, "
          f"{wall * 1e3:.1f} ms wall under the profiler, device busy {busy:.1f} ms = "
          f"{100 * busy / 1e3 / wall:.1f}%, {ops / (len(batches) * cs.B):.0f} device "
          f"ops per frame, on {card}")


def profile_lm(dev, card):
    """Device ops per LM step and device-busy share over 10 LM steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mcptam_tpu_torch.ba.bundle import create_lm_state, lm_run

    prob, cams = cs.lm_problem(dev)
    st = lm_run(prob, create_lm_state(prob), cams, 10, fixed_b=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = lm_run(prob, st, cams, 10, fixed_b=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, ops = _device_share(prof, wall)
    print(f"LM window: 10 steps in {wall * 1e3:.1f} ms wall under the profiler, "
          f"device busy {busy:.1f} ms = {100 * busy / 1e3 / wall:.1f}%, "
          f"{ops / 10:.0f} device ops per LM step, on {card}")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=12,
                                    max_name_column_width=60))
    return 0


def profile_live(cams, cfb, cams_sbi, card, n_window):
    """Phase 7's live session with every section of process_frame timed to
    a device synchronise, then a profiler window of process_frame."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mcptam_tpu_torch.config import MapMakerConfig, TrackerConfig
    from mcptam_tpu_torch.core.se3 import SE3
    from mcptam_tpu_torch.io.synthetic import render_rig
    from mcptam_tpu_torch.system import system as system_mod

    dev = cfb.t.device
    masks = torch.ones((cs.C, cs.H, cs.W), dtype=torch.bool, device=dev)
    masks[:, cs.H - cs.MASK_BAND:, :] = False
    sys_ = system_mod.System(cams, cfb, cams_sbi, cs.H, cs.W, tcfg=TrackerConfig(),
                             mcfg=MapMakerConfig(), max_points=cs.MAX_POINTS,
                             max_mkfs=cs.MAX_MKFS, max_meas=cs.MAX_MEAS, masks=masks)
    sys_.set_var("GlareMasking", True)

    def render(tangent):
        pose = SE3.exp(torch.tensor(tangent, dtype=torch.float32, device=dev))
        return torch.clamp(render_rig(cams, cfb, pose, cs.SEED, cs.H, cs.W),
                           0, 255).to(torch.uint8)

    walk = [render(cs.live_tangent(i)) for i in range(cs.N_LIVE_WALK)]
    traj = [render(cs.traj_tangent(i)) for i in range(cs.N_RETURN + n_window)]
    panel = torch.as_tensor(cs.panel_frame(), device=dev)

    sections, depth = {}, []

    def timed(name, fn):
        def run(*a, **k):
            if depth:                    # nested inside a timed section
                return fn(*a, **k)
            depth.append(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            depth.clear()
            sections.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    filt = system_mod.filter_frame_candidates
    sys_._features = timed("features (mask, glare)", sys_._features)
    sys_.mapmaker.init = timed("bootstrap (MapMaker.init)", sys_.mapmaker.init)
    sys_._device_step = timed("tracker step", sys_._device_step)
    sys_._reloc_fn = timed("relocalisation attempt", sys_._reloc_fn)
    sys_.mapmaker.step = timed("map-maker tick", sys_.mapmaker.step)
    system_mod.filter_frame_candidates = timed("candidate filter", filt)
    frames = walk + [panel] * 4 + traj[:cs.N_RETURN]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        infos = [sys_.process_frame(f) for f in frames]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        system_mod.filter_frame_candidates = filt
    print(f"live session: {len(frames)} process_frame frames, {wall:.2f} s wall with a "
          f"synchronise per section ({len(frames) / wall:.2f} frames/s), "
          f"{sum(i.added_mkf for i in infos)} MKFs added, "
          f"{sum(i.relocalized for i in infos)} relocalised, on {card}:")
    for name, v in sections.items():
        print(f"  {name:28s} n={len(v):3d}  mean {np.mean(v):9.3f} ms  "
              f"max {np.max(v):9.3f} ms  total {np.sum(v):9.1f} ms")

    for name in ("_features", "_device_step", "_reloc_fn"):
        delattr(sys_, name)
    del sys_.mapmaker.init, sys_.mapmaker.step
    window = traj[cs.N_RETURN:cs.N_RETURN + n_window]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in window:
            sys_.process_frame(f)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, ops = _device_share(prof, wall)
    on_dev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    print(f"live window: {len(window)} process_frame frames, {wall * 1e3:.1f} ms wall "
          f"under the profiler, device busy {busy:.1f} ms = {100 * busy / 1e3 / wall:.1f}%, "
          f"{ops / len(window):.0f} device ops per frame "
          f"({_fast_ops(on_dev) / len(window):.2f} FAST front-end), on {card}")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15,
                                    max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
