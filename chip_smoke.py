#!/usr/bin/env python3
"""Drive the PyTorch port's tracking path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: require CUDA; print the card and its power limit;
  2. build the CUDA kernels from mcptam_tpu_torch/csrc (timed);
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the tracking path gives it, with the tolerance stated, timed
     beside the plain version;
  4. the slice: render the 4-camera 480x640 rig and build the ground-truth
     map on the card, then run System.process_frames over the 128-pose
     benchmark trajectory in batches of 8 with the benchmark's quality
     gates, counting kernel launches; then a second, timed pass.

Prints one JSON line of kernel results, the card line, and last the line
{"ok": true, "device": {...}}.  Exits non-zero, with no result, when no
CUDA device is present or any phase fails.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

# the benchmark deployment (bench.py): 4-camera VGA fisheye rig, a
# ground-truth map of 2048 point / 16 MKF / 8192 measurement slots built
# with 72 candidates per level, the default TrackerConfig, B = 8
H, W, C = 480, 640, 4
MAX_POINTS, MAX_MKFS, MAX_MEAS = 2048, 16, 8192
N_PER_LEVEL = 72
N_POSES = 128
B = 8
SEED = 3.0
ESM_TOL = 3e-5  # the reference's own kernel-vs-XLA bar on se2

KERNELS = {
    "fast_frontend": ("mcptam_tpu_torch/csrc/fast.cu",
                      "mcptam_tpu/ops/fast_pallas.py:73"),
    "gather_windows": ("mcptam_tpu_torch/csrc/gather.cu",
                       "mcptam_tpu/ops/pallas_gather.py:26"),
    "esm_align_all": ("mcptam_tpu_torch/csrc/esm.cu",
                      "mcptam_tpu/ops/sbi_pallas.py:85"),
}


def traj_tangent(i: int) -> list:
    """Pose i of the benchmark's closed trajectory (bench.py:97-108)."""
    a = 2.0 * np.pi * i / N_POSES
    return [
        0.020 * np.sin(a), -0.015 * np.sin(2 * a + 0.7), 0.020 * np.cos(a),
        0.0040 * np.sin(a + 1.3), 0.0030 * np.cos(2 * a),
        0.0030 * np.sin(3 * a + 0.5),
    ]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn over reps launches, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_fast(images):
    """K1 on the four pyramid levels of a rendered frame: exact."""
    import torch
    from mcptam_tpu_torch.ops.fast_kernel import fast_frontend, fast_frontend_reference
    from mcptam_tpu_torch.ops.pyramid import build_pyramid

    pyr = [p.contiguous() for p in build_pyramid(images)]
    err = 0.0
    for lvl, p in enumerate(pyr):
        got, ref = fast_frontend(p), fast_frontend_reference(p)
        torch.cuda.synchronize()
        for name, a, b in zip(("score", "nm", "freq", "freq_nm"), got, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"fast_frontend level {lvl} {name} differs: "
                                     f"max |d| {(a - b).abs().max().item()}")
            err = max(err, (a - b).abs().max().item())
    ms = time_ms(lambda: [fast_frontend(p) for p in pyr])
    plain_ms = time_ms(lambda: [fast_frontend_reference(p) for p in pyr])
    return err, ms, plain_ms


def check_gather(feats, atlas_u8, gen):
    """K2 for the fine (K=1000, G=35) and coarse (K=60, G=31) search
    regions on the packed f32 atlas, and source windows (G=26) on the
    uint8 keyframe atlas: exact."""
    import torch
    from mcptam_tpu_torch.ops.gather_kernel import gather_windows, gather_windows_reference
    from mcptam_tpu_torch.ops.patch import pack_corner_atlas

    packed = pack_corner_atlas(feats.atlas, feats.corner_atlas)
    plane = packed.reshape(-1, packed.shape[-1])
    plane_u8 = atlas_u8.reshape(-1, atlas_u8.shape[-1])
    dev = plane.device
    cases = [(plane, 1000, 35), (plane, 60, 31), (plane_u8, 1000, 26)]
    err = 0.0
    for pl, K, G in cases:
        # starts spill past every edge so the clamp is exercised too
        rows = torch.randint(-8, pl.shape[0] - G + 8, (K,), generator=gen).to(dev)
        cols = torch.randint(-8, pl.shape[1] - G + 8, (K,), generator=gen).to(dev)
        got = gather_windows(pl, rows, cols, G)
        ref = gather_windows_reference(pl, rows, cols, G)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"gather_windows {pl.dtype} K={K} G={G} differs")
        err = max(err, (got - ref).abs().max().item())
    rows = torch.randint(0, plane.shape[0] - 35, (1000,), generator=gen).to(dev)
    cols = torch.randint(0, plane.shape[1] - 35, (1000,), generator=gen).to(dev)
    ms = time_ms(lambda: gather_windows(plane, rows, cols, 35))
    plain_ms = time_ms(lambda: gather_windows_reference(plane, rows, cols, 35))
    return err, ms, plain_ms


def check_esm(feats_prev, feats_cur):
    """K3 for C=4 on real SBI pairs: se2 within ESM_TOL."""
    import torch
    from mcptam_tpu_torch.ops.sbi_kernel import esm_align, esm_align_all

    args = (feats_prev.sbi, feats_cur.sbi, feats_cur.sbi_gx, feats_cur.sbi_gy)
    se2_k, score_k = esm_align_all(*args)
    se2_p, score_p = esm_align(*args)
    torch.cuda.synchronize()
    err = (se2_k - se2_p).abs().max().item()
    if not err <= ESM_TOL or not torch.isfinite(score_k).all():
        raise AssertionError(f"esm_align_all se2 differs by {err} > {ESM_TOL}")
    ms = time_ms(lambda: esm_align_all(*args))
    plain_ms = time_ms(lambda: esm_align(*args))
    return err, ms, plain_ms


def pose_errors(infos, poses):
    """Per-frame pose error (rotation angle (+) translation), as the
    benchmark's max_pose_err; frame i maps to trajectory pose i % N_POSES."""
    errs = []
    for info in infos:
        Rg, tg = poses[info.frame_id % N_POSES]
        Re, te = info.pose[:, :3], info.pose[:, 3]
        dR = Re @ Rg.T
        ang = np.arccos(np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0))
        errs.append(float(np.hypot(ang, np.linalg.norm(te - dR @ tg))))
    return errs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mcptam_tpu_torch  # noqa: F401  (sets the TF32 flags)
    from mcptam_tpu_torch import backend
    from mcptam_tpu_torch.config import TrackerConfig
    from mcptam_tpu_torch.core.se3 import SE3
    from mcptam_tpu_torch.csrc._build import build, load
    from mcptam_tpu_torch.io.synthetic import (
        build_groundtruth_map, make_rig, make_sbi_cams, render_rig,
    )
    from mcptam_tpu_torch.map.keyframe import make_frame_features
    from mcptam_tpu_torch.system.system import System

    # ---- 1. device and card
    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {name}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"card: {card}")

    # ---- 2. build
    t0 = time.perf_counter()
    path, log = build()
    load()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {path}")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- scene: rig, ground-truth map and trajectory frames, on the card
    t0 = time.perf_counter()
    cams, cfb = make_rig(C, H, W, spread_deg=25.0, device=dev)
    cams_sbi = make_sbi_cams(cams, H, W)
    ms, feats0 = build_groundtruth_map(
        cams, cfb, H, W, n_per_level=N_PER_LEVEL, max_points=MAX_POINTS,
        max_mkfs=MAX_MKFS, max_meas=MAX_MEAS)
    poses, frames = [], []
    for i in range(N_POSES):
        pose = SE3.exp(torch.tensor(traj_tangent(i), dtype=torch.float32, device=dev))
        poses.append((pose.R.cpu().numpy(), pose.t.cpu().numpy()))
        frames.append(torch.clamp(render_rig(cams, cfb, pose, SEED, H, W),
                                  0, 255).to(torch.uint8))
    torch.cuda.synchronize()
    n_pts = int(ms.points.valid.sum())
    print(f"scene: {N_POSES} frames + map of {n_pts} points in "
          f"{time.perf_counter() - t0:.2f} s")

    # ---- 3. kernels against their plain versions, at slice shapes
    gen = torch.Generator().manual_seed(0)
    feats1 = make_frame_features(frames[1])
    results = {
        "fast_frontend": check_fast(frames[0].to(torch.float32)),
        "gather_windows": check_gather(feats0, ms.mkfs.atlas, gen),
        "esm_align_all": check_esm(make_frame_features(frames[0]), feats1),
    }
    for k, (err, ms_k, ms_p) in results.items():
        print(f"kernel {k}: max_abs_err {err} kernel {ms_k:.4f} ms "
              f"plain {ms_p:.4f} ms ({card})")

    # ---- 4. the slice
    sys_ = System(cams, cfb, cams_sbi, H, W, tcfg=TrackerConfig(),
                  max_points=MAX_POINTS, max_mkfs=MAX_MKFS, max_meas=MAX_MEAS,
                  pipeline_depth=2 * B)
    sys_.ms = ms
    sys_.initialized = True
    sys_.vars["AddingMKFs"] = False
    batches = [torch.stack(frames[i:i + B]) for i in range(0, N_POSES, B)]

    backend.reset_launch_counts()
    infos = []
    for b in batches:
        infos += sys_.process_frames(b)
    infos += sys_.flush_pipeline()
    torch.cuda.synchronize()
    launches = backend.kernel_report()

    ids = [i.frame_id for i in infos]
    if ids != list(range(N_POSES)):
        raise AssertionError(f"drained frame ids out of order: {ids[:10]}...")
    found = [i.n_found for i in infos]
    errs = pose_errors(infos, poses)
    mean_found, max_err = float(np.mean(found)), float(np.max(errs))
    print(f"slice: {N_POSES} frames, mean_found {mean_found:.1f}, "
          f"max_pose_err {max_err:.6f}, lost {sum(i.lost for i in infos)}, "
          f"launches {launches}")
    if not all(np.isfinite(i.pose).all() and np.isfinite(i.cov_raw).all()
               for i in infos):
        raise AssertionError("non-finite pose or covariance")
    if mean_found < 100 or max_err >= 0.05:
        raise AssertionError(f"quality gates failed: mean_found {mean_found} "
                             f"(>= 100), max_pose_err {max_err} (< 0.05)")
    for k in KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the main path")

    # second pass over the closed trajectory, timed after the warm first
    t0 = time.perf_counter()
    infos2 = []
    for b in batches:
        infos2 += sys_.process_frames(b)
    infos2 += sys_.flush_pipeline()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    max_err2 = float(np.max(pose_errors(infos2, poses)))
    if max_err2 >= 0.05:
        raise AssertionError(f"second pass max_pose_err {max_err2}")
    print(f"slice timed pass: {N_POSES / dt:.2f} frames/s "
          f"({dt * 1e3 / N_POSES:.3f} ms/frame, B={B}, max_pose_err "
          f"{max_err2:.6f}) on {card}")

    kernels = [
        {"name": k, "route": "cuda", "source": KERNELS[k][0],
         "replaces": KERNELS[k][1], "launches": launches[k],
         "max_abs_err": results[k][0], "ms": results[k][1],
         "plain_ms": results[k][2]}
        for k in KERNELS
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
