#!/usr/bin/env python3
"""Drive the PyTorch port's tracking, mapping and live paths, its
`mcptam` app, its client/server split, its calibration and its sharded
(parallel/mesh.py) functions once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: require CUDA; print the card and its power limit;
  2. build the CUDA kernels from mcptam_tpu_torch/csrc (timed);
  3. each kernel against its plain PyTorch version on the card, at the
     shapes its path gives it, with the tolerance stated, timed beside the
     plain version and, where one PyTorch call computes the same function,
     beside that call: FAST (the four levels of a frame in one launch, and
     each level alone), the window gather at the tracker's former shapes
     and at the map-maker's largest call (the epipolar pass's 26x26 uint8
     source windows), ESM at the tracker's shape (4 cameras, 9
     iterations) and the relocaliser's (1 camera, 12 iterations), both
     SPD Cholesky solves at n = 96 and 288 on random SPD matrices and on
     the reduced camera system of one LM step of phase 5's problem (timed
     at both sizes beside torch.linalg.solve and torch.linalg.cholesky +
     torch.cholesky_solve), K4's global path (its launches a solve, NB
     and TILE printed) at n = 324, 384, 576 and 1536 and on the Schur
     matrix of phase 5's problem in a 64-MKF capacity (n = 384), and
     timed at n = 288 too, a size its route leaves to the shared K4, the
     half-sample on random f32 and a rendered
     frame, the unaligned gather on 3840 windows of 29 and of 9 pixels,
     some overrunning the plane, the fused patch search on the coarse
     and fine calls of a tracked batch (box sums bit-exact, offsets up to
     near-ties), MiniPatch's fused round trip on every candidate of a
     frame pair (3840; consecutive trajectory frames and a pair turned
     apart, candidates moved onto the level borders; bit-exact, timed
     beside the path it replaced in turns, and its device operations
     against that path's), make_sbi with ESM on a 480x752 rig, whose
     SBI needs the linear resize, and FAST on the row slabs of a frame
     sharded over two ranks, its histograms over each rank's own rows
     (bit-exact);
  4. the tracking slice: render the 4-camera 480x640 rig and build the
     ground-truth map on the card, then run System.process_frames over
     the 128-pose benchmark trajectory in batches of 8 with the
     benchmark's quality gates, counting kernel launches; then a second,
     timed pass, and the device operations of a tracked frame with the
     fused search and with the plain one (torch.profiler);
  5. LM: the benchmark's global bundle problem (16 poses, 2048 points,
     8192 measurements), LM iterations/s over 6 chunks of 10, the
     noiseless fidelity problem (mean reprojection error < 1e-3 px after
     100 iterations), the timed problem again on the unblocked Cholesky
     kernel, and placed in a 64-MKF capacity (n = 384) on K4's global
     path against the same run on the plain solver in float64;
  6. mapping: System.process_frames with the map-maker ticking (ba_chunk
     4, a tick every 2nd batch), a warm-up of 88 frames that walks the rig
     0.3 m sideways and back so that keyframes are added and integrated,
     then the timed 128-pose trajectory with the benchmark's gates (ATE
     included), at least one MKF integrated and one BA finished with
     accepted steps;
  7. live: a fresh System with a static mask (a 32-px bottom band) and
     glare masking drives System.process_frame: it bootstraps its own map
     from frame 0, walks the sideways warm-up, turning in yaw, so that
     keyframes are added through the MiniPatch candidate filter, loses
     track on quadrant-panel frames, relocalises when it returns to
     trajectory pose 0 and tracks on; gates mean_found and ATE over the frames outside the lost stretch;
     then the map is saved and loaded into a second System, and both track
     the next 8 frames to the same poses;
  8. the app: phase 7's 24 warm-up frames written as a PGM dataset
     directory with its rig document (masks included) and ground truth,
     then `python -m mcptam_tpu_torch.apps.mcptam` run in-process on the
     card, once frame by frame (process_frame) and once with --batch 8
     --pipeline 2 (process_frames), both through the native frame queue:
     every frame reported once and in order, none lost, ATE, an MKF added,
     the map, PLY and keyframe overlays written, every kernel of the live
     path launched; then on the first run's System profile_frame's stage
     table, small_image, align_to_dominant_plane on the tracked map and
     on it pressed flat (camera-frame coordinates kept either way; the
     flat map aligned) and plane_align_transform on tests/test_align.py's
     planar cloud;
  9. client/server: (a) in one process, a MapServer on a thread and a
     SystemClient talking to it over loopback TCP, both at a 64-MKF
     capacity (every LM step of the server's BA on K4's global route), fed
     phase 7's 24 warm-up frames one by one: every frame reported, none
     lost, ATE, an MKF added and integrated, SRC_TRACKER measurements and
     a monitor packet on the server, the client's point and measurement
     sections equal to the server's last UPDATE after the final exchange,
     no exception logged by the server loop, the kernels of both sides
     launched; it prints the frames/s, the messages and bytes each way,
     how each keyframe message's image travelled (JPEG or raw) and the
     server's LM steps; (b) the server app and the client app as two
     processes on phase 8's dataset, the server at the default capacity:
     the client exits with 0 after reporting every frame once, none lost,
     and SIGTERM stops the server with 0;
 10. calibration, on the card: (a) the camera calibrator app in-process
     on tests/test_calib.py's six board poses at that test's 240x320 (RMS
     "OK", a0 within 5%, the centre within 2 px; the seconds of detection,
     linear solve and device LM printed; at 480x640 both packages' linear
     initialisation misses, ROADMAP section C); (b) at H x W, the pose
     calibrator app on tests/test_apps.py's 2-camera shared-board video,
     its lens scaled to the frame, on its default (shared-board) path,
     against the true extrinsic; (c) at H x W, PoseCalibSession on
     scripts/zero_overlap_drive.py's rig, whose cameras never see the
     board together, its lens scaled to the frame: 48 frames with
     projected detections (0.05 px noise), 48 MKFs, then calib_init and
     calib_step(40), gated as that drive is (both cameras running, a sync
     group of both, the extrinsic's rotation and translation errors); it
     prints frames/s, MKFs and groups, the BA's LM steps and the Schur
     sizes they solved;
 11. parallel (parallel/mesh.py), at phase 4's scene and phase 5's
     problems: (a) world 1 over NCCL in this process, each sharded
     function held bit-identical to the unsharded port and timed beside
     it: sharded_lm_run_soa for 10 steps on phase 5's problem (n = 96, the
     shared K4) and in a 64-MKF capacity (n = 384, K4's global route),
     sharded_lm_run for 3 steps on that problem without an observation
     table, sharded_epipolar_match on the epipolar call of an MKF
     integrated into the ground-truth map, sharded_track_frame on 8
     trajectory frames whose features come from sharded_frame_features
     on (4,480,640); (b) the same at world 2, two processes on the card in
     a gloo group: every rank's results and Schur matrices identical, the
     features, the tracker's and the epipolar search's integers exact and
     floats within tolerance, each LM run's first step's reduced system
     within 1e-5 of the unsharded one with the median exact, the final
     costs within 1e-4.

Each path's launch counts are set to 0 just before it and read just after;
the FAST front-end must launch once a frame (phase 6 adds the features the
batch drain computes again for a keyframe add or a relocalisation), and the
fused round trip once a keyframe add that went through the candidate
filter (phase 7).  Phase 6 also records the shapes of every window-gather
call it makes.
Prints one JSON line of kernel results, the card line, and last the line
{"ok": true, "device": {...}}.  Exits non-zero, with no result, when no
CUDA device is present or any phase fails.
"""

import json
import logging
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
# SPD solves: max |x - x_plain| / max |x_plain|, both in f32.  1e-3 bounds
# kappa * 2^-24 at the random matrices' condition number 1e4; a worse
# conditioned Schur matrix gets 8 kappa 2^-24 (kappa measured in f64)
SPD_TOL = 1e-3
# the damped Schur matrix is ill-conditioned (kappa ~1e7), so there the
# kernel is held to the plain solver's backward error instead:
# ||A x - b||_inf / (||A||_inf ||x||_inf + ||b||_inf) <= SPD_BACKWARD_TOL,
# a few n * 2^-24 at n = 96
SPD_BACKWARD_TOL = 2e-5
MIN_FOUND, MAX_POSE_ERR, MAX_ATE = 100.0, 0.05, 0.02   # bench.py's gates
BA_CHUNK, TICK_EVERY = 4, 2   # the benchmark's map-maker deployment
N_WARMUP, EXCURSION_M = 88, 0.3
LM_COST_TOL = 1e-2  # K5 vs K4 final LM cost: the accept path may differ by f32 rounding
# the live phase: sideways warm-up frames, at most this many panel frames
# to lose track, trajectory frames after the loss, frames after the map
# round trip, their pose tolerance, and the static mask's bottom band
N_LIVE_WALK, N_PANEL_MAX, N_RETURN, N_RESUME = 24, 8, 16, 8
RESUME_TOL, MASK_BAND = 1e-5, 32
# the app phase: profile_frame's frames (one warm-up), the relative change
# of camera-frame point coordinates the plane alignment may make (float32
# transforms of coordinates ~1-10 m), and the aligned planar cloud's |z|
N_PROFILE, ALIGN_TOL, PLANE_Z_TOL = 5, 1e-4, 0.01
N_PLANE = 80       # tests/test_align.py's planar cloud: its points on the plane
# the live warm-up also turns the rig in yaw, by up to LIVE_YAW rad: the
# tracker's coarse search (30 px at level 0, ~10 deg) recovers a sideways
# offset of 0.22 m on the first frame back by itself, so only a turned
# loss pose leaves relocalisation to do the recovery
LIVE_YAW = 0.5
N_GATHER_WINDOWS = 3840   # 4 cams x (512 + 256 + 128 + 64) candidates
# MiniPatch's round trip: candidates moved to these distances (level px)
# from each image edge, inside the template's 4-px margin, the region's
# 14-px margin and where only the return search's region leaves the image;
# the second pair's current frame is live_tangent(FAR_POSE), turned
# ~5 deg and moved 4 cm sideways from trajectory pose 0
BORDER_DISTANCES = (0, 1, 2, 3, 4, 5, 9, 13, 14, 15, 19, 23, 24, 25)
FAR_POSE = 4
# MiniPatch's search: offsets (21 x 21), template terms (9 x 9), and the
# operations a term (difference, square, sum)
MINI_OFFSETS, MINI_TERMS, MINI_TERM_OPS = 441, 81, 3
# the map-maker's largest window gather: an integration's "other" epipolar
# pass stacks the cameras' 32 strongest candidates of a level
# (map/mapmaker_core.py::integrate_mkf, cap_per_level) and gathers a 26x26
# source window for each of MapMakerConfig.epi_max_hypotheses hypotheses
EPI_CAP_PER_LEVEL, EPI_WINDOW = 32, 26
RELOC_ITERATIONS = 12     # tracker/reloc.py's ESM call on one camera
# the fused search against its plain version: found flags and best
# offsets agree on SEARCH_AGREE of the pairs, each disagreement a near-tie
# (best ZMSSD within SEARCH_TIE relative): the cross term sums in another
# order than cuDNN's; subpixel positions of agreeing pairs within 1e-3 px
SEARCH_AGREE, SEARCH_TIE, SUBPIX_TOL = 0.99, 1e-3, 1e-3
# K4's global path: random SPD beyond the shared range, up to 256 MKFs
# (n = 6 x 256), and the phase 5 problem placed in a 64-MKF capacity
SPD_GLOBAL_SIZES, CAPACITY_MKFS = (324, 384, 576, 1536), 64
SHARED_CAPACITY = 288     # the default 48 MKFs: the shared K4's, timed on the global path too
# the capacity run's final LM cost against the same run on the plain
# solver in float64.  Not in float32: at 64 MKFs that run's accept/reject
# path departs from both the float64 run and K4's (the phase prints all
# three costs)
CAPACITY_COST_TOL = 1e-4
# a camera that does not halve to the 30x40 SBI: 480x752 halves to 30x47
# and make_sbi finishes with the reference's linear resize
RESIZE_H, RESIZE_W = 480, 752
SBI_TOL = 1e-4          # the card's SBI against the CPU's
# the client/server phase: (a) runs both sides at a 64-MKF capacity, so
# every LM step of the server's BA solves n = 384, K4's global route; after
# the last frame the server's queue must empty and a BA finish within
# CS_DEADLINE_S, and so must the final exchange; (b) gives the server app
# CS_START_S to print its port and the client app CS_CLIENT_TIMEOUT_S for
# the whole run
CS_MAX_MKFS, CS_DEADLINE_S = 64, 120.0
CS_START_S, CS_CLIENT_TIMEOUT_S = 120.0, 300.0
# the calibration phase.  (b) renders tests/test_apps.py's six board poses
# and lens (a 240x320 lens there) at H x W, the lens scaled to the frame by
# CALIB_SCALE; (c) is scripts/zero_overlap_drive.py's 2-camera rig, scene
# and 48-frame trajectory (a 128x96 lens there) scaled by ZO_SCALE.  A lens
# scales exactly with the image: a_i <- a_i s^(1-i), centre <- s centre
CALIB_SCALE, ZO_SCALE = 2.0, 5.0
# (a) runs at tests/test_calib.py's own 240x320 (scale 1): at 480x640 the
# linear initialisation's centre search (calib/intrinsic.py::calibrate_linear)
# settles on a wrong centre, (248, 305) against (326, 244), where the
# algebraic residual is lower, and the LM ends at 1.498 px RMS in both
# packages (ROADMAP section C)
CALIB_CAMERA_H, CALIB_CAMERA_W = 240, 320
CALIB_SQUARES, CALIB_SQ = (8, 6), 0.04
CALIB_PARAMS = [95.0, -0.0045, 3.0e-6, -6.0e-9, 163.0, 122.0, 1.0, 0.0, 0.0]
CALIB_BOARD_POSES = [      # board_from_cam tangents (t, w), tests/test_calib.py
    [0.22, 0.14, 0.18, 3.05, 0.10, 0.0], [0.28, 0.10, 0.30, 3.00, -0.45, 0.1],
    [0.14, 0.20, 0.42, 3.1, 0.35, -0.35], [0.30, 0.08, 0.24, 2.85, 0.0, 0.45],
    [0.18, 0.13, 0.55, 3.25, -0.3, -0.2], [0.25, 0.22, 0.34, 3.0, 0.5, 0.3],
]
CALIB_REL_W, CALIB_REL_T = [0.02, 0.30, -0.03], [-0.20, 0.02, 0.05]  # cam1_from_cam0
# tests/test_apps.py's gates: a0 relative, centre px, rotation, translation m
CALIB_A0_TOL, CALIB_CENTRE_PX, CALIB_ROT_TOL, CALIB_TRANS_TOL = 0.05, 2.0, 0.02, 0.03
ZO_SQUARES, ZO_SQ, ZO_SEP = (8, 6), 0.25, np.radians(60.0)
ZO_PARAMS = [0.75 * 128, -0.0035, 1.0e-6, -6.0e-9, 128 / 2.0 + 1.0, 96 / 2.0 + 1.0,
             1.001, 0.0003, -0.0002]
ZO_REL_W, ZO_REL_T = [0.0, -ZO_SEP, 0.02], [0.22, -0.03, 0.06]
ZO_FRAMES, ZO_ROT_START, ZO_ROT_END = 48, 4, 20
ZO_NOISE_PX, ZO_MAX_MKFS, ZO_KF_DIST = 0.05, 48, 0.05
ZO_ROT_TOL, ZO_TRANS_TOL = 0.01, 0.02    # the drive's gates (tests/test_pose_calib.py)
# (c)'s window gathers and Schur solves held against their plain versions:
# the first call of each shape, at most this many a kernel
ZO_HOLDS = 8
# the session stops a camera after this many frames in a row that are not
# GOOD (calib/pose_calib.py::process_frame); (c) prints how close each
# camera came, over all its frames and the last ZO_MARGIN_FRAMES
ZO_STOP_STREAK, ZO_MARGIN_FRAMES = 5, 8
# the parallel phase (parallel/mesh.py): (b)'s world runs as that many
# processes on the one card under gloo (NCCL refuses two ranks on one GPU);
# LM steps on phase 5's problem and its 64-MKF capacity, steps of the
# problem without an observation table, tracked trajectory frames, the
# pose the integrated MKF (the epipolar call's source) is taken at
PAR_WORLD, PAR_LM_STEPS, PAR_SCATTER_STEPS, PAR_TRACK_FRAMES = 2, 10, 3, 8
PAR_MKF_POSE = N_WARMUP // 4
# (b) against the unsharded run: the first LM step from the same state
# solves a reduced system summed in another order, within PAR_SCHUR_TOL of
# the unsharded one relative to its largest entry (float32 sums of 8192
# terms), with the median sigma exact, and its whole state is held: the
# accept flag exact, poses within PAR_POSE_TOL, the back-substituted
# points within PAR_POINT_TOL; the later steps of a float32 LM, undamped
# to lambda 1e-8 on a Schur matrix of kappa ~1e7, part ways under any
# change in the order of its sums, so after them only the final cost is
# held, within PAR_COST_TOL, and the counts and the poses' and points'
# differences are printed
PAR_SCHUR_TOL, PAR_COST_TOL = 1e-5, 1e-4
# the LM path without a table accumulates its normal equations with
# index_put_/index_add_, atomics on the card, so two unsharded runs differ
# too: it is held within PAR_COST_TOL and PAR_POSE_TOL at every world size
# tests/test_parallel.py's tolerances (rtol, atol): poses, points, and the
# epipolar search's target positions.  Its triangulated points are held
# to the point tolerance: on the card each rank's Q/2 candidates go
# through batched products that round otherwise than at Q (cuBLAS picks
# its kernels by shape), and the midpoint triangulation turns a target
# position 1.5e-5 px off into a point ~1e-4 relative off (on an H100, 34
# of phase 11's 42 matched points moved, at most 1.24e-4 relative).  (b)
# checks that cause: the unsharded search called on each half of Q in one
# process gives the world's result bit for bit
PAR_POSE_TOL, PAR_POINT_TOL, PAR_EPI_UV_TOL = (1e-4, 1e-5), (1e-3, 1e-4), (1e-4, 1e-3)
PAR_EPI_POS_TOL = PAR_POINT_TOL
PAR_TIMEOUT_S = 600
# the H100 SXM's published peaks: HBM bytes/s and f32 operations/s outside
# the tensor cores
PEAK_BYTES_S, PEAK_F32_OPS_S = 3.35e12, 67e12
# operations a pixel of the FAST front-end does: 16 ring differences, for
# bright and dark a 10-of-16 arc minimum in 4 doubling steps over the 16
# starts and their maximum, the 3x3 nonmax, two histogram bins
FAST_OPS_PER_PIXEL = 200
# operations an ESM iteration does per template pixel: the warp, the
# bilinear read, gradients, the 4-vector Jacobian and residual, and the 14
# normal-equation sums
ESM_OPS_PER_PIXEL = 64

KERNELS = {
    "fast_frontend": ("mcptam_tpu_torch/csrc/fast.cu",
                      "mcptam_tpu/ops/fast_pallas.py:73"),
    "half_sample": ("mcptam_tpu_torch/csrc/halfsample.cu",
                    "scripts/test_pallas_halfsample.py:12,18 (K6); "
                    "scripts/test_pallas_halfsample.py:91,98 (K7)"),
    "gather_unaligned": ("mcptam_tpu_torch/csrc/gather_unaligned.cu",
                         "scripts/profile_gather.py:21"),
    "stability_filter": ("mcptam_tpu_torch/csrc/minipatch.cu",
                         "scripts/profile_gather.py:21 (K8 on MiniPatch's path, with "
                         "mcptam_tpu/ops/minipatch.py:79 stability_filter)"),
    "gather_windows": ("mcptam_tpu_torch/csrc/gather.cu",
                       "mcptam_tpu/ops/pallas_gather.py:26"),
    "search_patches": ("mcptam_tpu_torch/csrc/search.cu",
                       "mcptam_tpu/ops/pallas_gather.py:26 (K2 on the tracker's path, "
                       "with mcptam_tpu/ops/batch_patch.py:165 find_patches)"),
    "esm_align_all": ("mcptam_tpu_torch/csrc/esm.cu",
                      "mcptam_tpu/ops/sbi_pallas.py:85"),
    "spd_solve_blocked": ("mcptam_tpu_torch/csrc/spd.cu",
                          "mcptam_tpu/core/spd.py:99"),
    "spd_solve_blocked_global": ("mcptam_tpu_torch/csrc/spd.cu",
                                 "mcptam_tpu/core/spd.py:99 (K4 beyond shared memory)"),
    "spd_solve_simple": ("mcptam_tpu_torch/csrc/spd.cu",
                         "mcptam_tpu/core/spd.py:33"),
}


def traj_tangent(i: int) -> list:
    """Pose i of the benchmark's closed trajectory (bench.py:97-108)."""
    a = 2.0 * np.pi * i / N_POSES
    return [
        0.020 * np.sin(a), -0.015 * np.sin(2 * a + 0.7), 0.020 * np.cos(a),
        0.0040 * np.sin(a + 1.3), 0.0030 * np.cos(2 * a),
        0.0030 * np.sin(3 * a + 0.5),
    ]


def excursion_tangent(i: int) -> list:
    """Warm-up pose i of phase 6: the trajectory pose plus a sideways
    excursion of up to EXCURSION_M that returns to it at frame N_WARMUP."""
    v = traj_tangent(i)
    v[0] += EXCURSION_M * np.sin(np.pi * i / N_WARMUP)
    return v


def live_tangent(i: int) -> list:
    """Warm-up pose i of phase 7: the phase 6 excursion, turned in yaw by a
    ramp that reaches LIVE_YAW at the last warm-up frame."""
    v = excursion_tangent(i)
    v[4] += LIVE_YAW * i / (N_LIVE_WALK - 1)
    return v


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def bound(n_bytes: float, n_ops: float):
    """The least time (ms) the card could take: bytes over the HBM rate or
    operations over the f32 rate, whichever is larger, and which it is."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_OPS_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, reps: int = 20, windows: int = 3) -> float:
    """Device time of fn, the median over ``windows`` timed windows of the
    mean over reps launches, after one warm-up.  Before each window a spin
    kernel holds the stream for longer than the host takes to enqueue the
    reps calls, so that the events time the device's work and not the
    host's launch rate; the median drops a window that a host stall left
    timing the host."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(windows):
        # cycles at the H100's 1.98 GHz top SM clock: at a lower clock it spins longer
        torch.cuda._sleep(int(min(1.5 * reps * host_s + 1e-3, 2.0) * 1.98e9))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def check_fast(images):
    """K1 on the four pyramid levels of a rendered frame (``hold_fast``),
    and on its row slabs as PAR_WORLD ranks of a sharded frame build them
    (``hold_fast_slabs``)."""
    from mcptam_tpu_torch.ops.pyramid import build_pyramid

    hold_fast_slabs(images, PAR_WORLD)
    return hold_fast([p.contiguous() for p in build_pyramid(images)])


def hold_fast_slabs(images, world: int):
    """K1's slab form: each rank's slab of rows (its rows and the halo) in
    one launch with the histograms over its own rows of each level
    (map/keyframe.py::row_slab), exact against the plain version on the
    same slab and rows."""
    import torch
    from mcptam_tpu_torch.map.keyframe import row_slab
    from mcptam_tpu_torch.ops.fast_kernel import fast_frontend_levels, fast_frontend_reference
    from mcptam_tpu_torch.ops.pyramid import build_pyramid

    for rank in range(world):
        r0, r1, s0, s1, rows = row_slab(images.shape[1], rank, world)
        pyr = [p.contiguous() for p in build_pyramid(images[:, s0:s1])]
        got = fast_frontend_levels(pyr, rows=rows)
        for lvl, (p, g, rr) in enumerate(zip(pyr, got, rows)):
            ref = fast_frontend_reference(p, rows=rr)
            torch.cuda.synchronize()
            for name, a, b in zip(("score", "nm", "freq", "freq_nm"), g, ref):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"fast_frontend slab of rank {rank}/{world} level {lvl} {name} "
                        f"differs: max |d| {(a - b).abs().max().item()}")
        print(f"kernel fast_frontend on rank {rank} of {world}'s slab: rows [{r0}, {r1}) "
              f"of {images.shape[1]}, slab [{s0}, {s1}), histogram rows per level {rows}: "
              f"exact")


def hold_fast(pyr):
    """K1 on pyramid levels, all levels in one launch and each level alone:
    exact.  Timed as the path calls it, one launch for the levels."""
    import torch
    from mcptam_tpu_torch.ops.fast_kernel import (
        fast_frontend, fast_frontend_levels, fast_frontend_reference,
    )

    levels = fast_frontend_levels(pyr)
    err = 0.0
    for lvl, p in enumerate(pyr):
        ref = fast_frontend_reference(p)
        for how, got in (("one launch", levels[lvl]), ("alone", fast_frontend(p))):
            torch.cuda.synchronize()
            for name, a, b in zip(("score", "nm", "freq", "freq_nm"), got, ref):
                if not torch.equal(a, b):
                    raise AssertionError(f"fast_frontend level {lvl} ({how}) {name} differs: "
                                         f"max |d| {(a - b).abs().max().item()}")
                err = max(err, (a - b).abs().max().item())
    ms = time_ms(lambda: fast_frontend_levels(pyr))
    plain_ms = time_ms(lambda: [fast_frontend_reference(p) for p in pyr])
    px = sum(p.numel() for p in pyr)
    # image in; score and nonmax out; two (C,64) histograms per level
    bnd = bound(px * 4 * 3 + len(pyr) * 2 * pyr[0].shape[0] * 64 * 4,
                px * FAST_OPS_PER_PIXEL)
    return err, ms, plain_ms, bnd, None


def check_gather(feats, atlas_u8, gen):
    """K2 for the fine (K=1000, G=35) and coarse (K=60, G=31) search
    regions on the packed f32 atlas, and source windows (G=26) on the
    uint8 keyframe atlas: exact.  Timed at the tracker's fine search
    (K=1000, G=35, f32) and at the map-maker's largest call, the epipolar
    pass's source windows (K = C x EPI_CAP_PER_LEVEL x hypotheses, G=26,
    uint8).  Returns the tracker's row and a row for each shape."""
    import torch
    from mcptam_tpu_torch.config import MapMakerConfig
    from mcptam_tpu_torch.ops.gather_kernel import gather_windows, gather_windows_reference
    from mcptam_tpu_torch.ops.patch import pack_corner_atlas

    packed = pack_corner_atlas(feats.atlas, feats.corner_atlas)
    plane = packed.reshape(-1, packed.shape[-1])
    plane_u8 = atlas_u8.reshape(-1, atlas_u8.shape[-1])
    dev = plane.device
    k_epi = C * EPI_CAP_PER_LEVEL * MapMakerConfig().epi_max_hypotheses
    cases = [(plane, 1000, 35), (plane, 60, 31), (plane_u8, 1000, 26),
             (plane_u8, k_epi, EPI_WINDOW)]
    err, sizes = 0.0, []
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
        if (K, G) in ((1000, 35), (k_epi, EPI_WINDOW)):
            rows, cols = rows.clamp(0, pl.shape[0] - G), cols.clamp(0, pl.shape[1] - G)
            ms_k = time_ms(lambda: gather_windows(pl, rows, cols, G))
            ms_p = time_ms(lambda: gather_windows_reference(pl, rows, cols, G))
            # the windows' pixels in and out, the starts in
            b_ms, b_by = bound(K * G * G * pl.element_size() * 2 + K * 2 * 8, 0)
            sizes.append({"K": K, "G": G, "dtype": str(pl.dtype).replace("torch.", ""),
                          "ms": ms_k, "plain_ms": ms_p, "bound_ms": b_ms, "bound_by": b_by,
                          "library_ms": None})
            print(f"  gather_windows K={K} G={G} {pl.dtype}: kernel {ms_k:.4f} ms, plain "
                  f"{ms_p:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    t = sizes[0]
    return (err, t["ms"], t["plain_ms"], (t["bound_ms"], t["bound_by"]), None), sizes


def check_esm(feats_prev, feats_cur):
    """K3 on real SBI pairs at the tracker's shape (C=4, 9 iterations) and
    the relocaliser's (camera 0 of the same pair, 12 iterations)
    (``hold_esm``)."""
    pair = (feats_prev.sbi, feats_cur.sbi, feats_cur.sbi_gx, feats_cur.sbi_gy)
    return hold_esm(((pair, 9), (tuple(a[:1].contiguous() for a in pair),
                                 RELOC_ITERATIONS)))


def hold_esm(cases):
    """K3 on (cur, target, gx, gy) arguments with their iteration counts:
    se2 within ESM_TOL.  Returns the first case's row and a row for each."""
    import torch
    from mcptam_tpu_torch.ops.sbi_kernel import esm_align, esm_align_all

    err, sizes = 0.0, []
    for args, iters in cases:
        se2_k, score_k = esm_align_all(*args, n_iterations=iters)
        se2_p, score_p = esm_align(*args, n_iterations=iters)
        torch.cuda.synchronize()
        e = (se2_k - se2_p).abs().max().item()
        if not e <= ESM_TOL or not torch.isfinite(score_k).all():
            raise AssertionError(f"esm_align_all C={args[0].shape[0]} {iters} iterations: "
                                 f"se2 differs by {e} > {ESM_TOL}")
        err = max(err, e)
        ms_k = time_ms(lambda: esm_align_all(*args, n_iterations=iters))
        ms_p = time_ms(lambda: esm_align(*args, n_iterations=iters))
        C_, R_, W_ = args[0].shape
        b_ms, b_by = bound(4 * C_ * R_ * W_ * 4 + C_ * 5 * 4,
                           C_ * R_ * W_ * iters * ESM_OPS_PER_PIXEL)
        sizes.append({"C": C_, "iterations": iters, "max_abs_err": e, "ms": ms_k,
                      "plain_ms": ms_p, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": None})
        print(f"  esm_align_all C={C_} {iters} iterations: se2 err {e:.3g}, kernel "
              f"{ms_k:.4f} ms, plain {ms_p:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    t = sizes[0]
    return (err, t["ms"], t["plain_ms"], (t["bound_ms"], t["bound_by"]), None), sizes


def check_half_sample(frame):
    """K6/K7 on random f32 (4,480,640) of many magnitudes and on a rendered
    frame, and down the pyramid and SBI chain (``hold_half_sample``)."""
    import torch
    from mcptam_tpu_torch.ops.pyramid import half_sample_reference

    gen = torch.Generator().manual_seed(1)
    x = torch.randn((C, H, W), generator=gen) * torch.pow(
        10.0, torch.randint(-3, 4, (C, H, W), generator=gen).to(torch.float32))
    cases = [x.to(frame.device), frame]
    for _ in range(4):                   # the SBI chain's levels, to 30x40
        cases.append(half_sample_reference(cases[-1]))
    return hold_half_sample(cases)


def hold_half_sample(cases):
    """K6/K7 on each image of ``cases``: bit-exact.  Timed at the first
    beside the plain version and F.avg_pool2d."""
    import torch
    import torch.nn.functional as F
    from mcptam_tpu_torch.ops.pyramid import half_sample, half_sample_reference

    for a in cases:
        got, ref = half_sample(a), half_sample_reference(a)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"half_sample differs at {tuple(a.shape)}: max |d| "
                                 f"{(got - ref).abs().max().item()}")
    a = cases[0]
    ms = time_ms(lambda: half_sample(a))
    plain_ms = time_ms(lambda: half_sample_reference(a))
    library_ms = time_ms(lambda: F.avg_pool2d(a, 2))
    # the image in, the half-size image out; 3 adds and a scale per output
    bnd = bound(a.numel() * 4 * 5 / 4, a.numel())
    return 0.0, ms, plain_ms, bnd, library_ms


def check_gather_unaligned(feats, gen):
    """K8 on the feature atlas plane at MiniPatch's full width: 3840
    windows of 29 and of 9 pixels, starts spilling past every edge so that
    the clip and the zero fill are exercised: bit-exact."""
    import torch
    from mcptam_tpu_torch.ops.gather_unaligned_kernel import (
        gather_unaligned, gather_unaligned_reference,
    )

    plane = feats.atlas.reshape(-1, feats.atlas.shape[-1]).contiguous()
    K = N_GATHER_WINDOWS
    for G in (29, 9):
        rows = torch.randint(-2 * G, plane.shape[0] + G, (K,), generator=gen).to(plane.device)
        cols = torch.randint(-2 * G, plane.shape[1] + G, (K,), generator=gen).to(plane.device)
        got = gather_unaligned(plane, rows, cols, G)
        ref = gather_unaligned_reference(plane, rows, cols, G)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"gather_unaligned G={G} differs")
        if G == 29:
            timed = (rows, cols)
    rows, cols = timed
    ms = time_ms(lambda: gather_unaligned(plane, rows, cols, 29))
    plain_ms = time_ms(lambda: gather_unaligned_reference(plane, rows, cols, 29))
    bnd = bound(K * 29 * 29 * 4 * 2 + K * 2 * 4, 0)
    return 0.0, ms, plain_ms, bnd, None


def at_borders(feats):
    """feats with the first candidates of every camera and level moved to
    BORDER_DISTANCES from each of the four image edges and made valid."""
    import dataclasses
    import torch

    xy, valid = [], []
    for l, (cxy, cv) in enumerate(zip(feats.cand_xy, feats.cand_valid)):
        h, w = H >> l, W >> l
        pts = [p for d in BORDER_DISTANCES
               for p in ((d, h // 2), (w - 1 - d, h // 3), (w // 3, d), (w // 2, h - 1 - d))]
        pts = torch.tensor(pts[:cxy.shape[1]], dtype=cxy.dtype, device=cxy.device)
        cxy, cv = cxy.clone(), cv.clone()
        cxy[:, :len(pts)] = pts
        cv[:, :len(pts)] = True
        xy.append(cxy)
        valid.append(cv)
    return dataclasses.replace(feats, cand_xy=tuple(xy), cand_valid=tuple(valid))


def stability_args(prev, cur) -> tuple:
    """The round trip's arguments for every candidate of a FrameFeatures
    pair, laid out as filter_frame_candidates lays them out: the two
    (C*H, AW) atlas planes, the descriptors, xy and validity."""
    import torch
    from mcptam_tpu_torch.ops.minipatch_kernel import level_descriptors

    C_, H_, AW = cur.atlas.shape
    sizes = tuple(v.shape[1] for v in cur.cand_valid)
    return (prev.atlas.reshape(C_ * H_, AW), cur.atlas.reshape(C_ * H_, AW),
            level_descriptors(C_, H_, AW, sizes, cur.atlas.device),
            torch.cat([x.reshape(-1, 2) for x in cur.cand_xy]),
            torch.cat([v.reshape(-1) for v in cur.cand_valid]))


def device_ops(fn) -> int:
    """Device operations (kernels, copies, sets) of one call of fn, from a
    torch.profiler window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type.name == "CUDA")


def check_stability(cams, cfb, frames):
    """MiniPatch's fused round trip (csrc/minipatch.cu) against
    stability_reference on every candidate of a frame pair at the live
    path's width (4 cameras x 960): consecutive trajectory frames, and
    trajectory pose 0 against live_tangent(FAR_POSE), both with candidates
    moved onto the level borders.  kept, ran, and where a search ran its
    found flag, position and SSD: bit-exact.  Timed on the consecutive pair
    beside the plain version and, in turns, the path it replaced (K8's
    kernel for every window, the eager search); then the device operations
    of one filter_frame_candidates call on either path."""
    import torch
    from mcptam_tpu_torch.core.se3 import SE3
    from mcptam_tpu_torch.io.synthetic import render_rig
    from mcptam_tpu_torch.map.keyframe import make_frame_features
    from mcptam_tpu_torch.ops import minipatch
    from mcptam_tpu_torch.ops.gather_unaligned_kernel import gather_unaligned
    from mcptam_tpu_torch.ops.minipatch_kernel import stability_reference, stability_search

    far = torch.clamp(render_rig(cams, cfb, SE3.exp(torch.tensor(
        live_tangent(FAR_POSE), dtype=torch.float32, device=cfb.t.device)), SEED, H, W),
        0, 255).to(torch.uint8)
    f0 = make_frame_features(frames[0])
    pairs = {"consecutive": (f0, at_borders(make_frame_features(frames[1]))),
             f"pose 0 -> live_tangent({FAR_POSE})": (f0, at_borders(make_frame_features(far)))}

    def parent(*a):
        return stability_reference(*a, gather=gather_unaligned)

    for label, (prev, cur) in pairs.items():
        args = stability_args(prev, cur)
        got, want = stability_search(*args), stability_reference(*args)
        torch.cuda.synchronize()
        ran = got.ran
        same = {"kept": torch.equal(got.kept, want.kept), "ran": torch.equal(ran, want.ran),
                "found": torch.equal(got.found[ran], want.found[ran]),
                "xy": torch.equal(got.xy[ran], want.xy[ran]),
                "ssd": torch.equal(got.ssd[ran], want.ssd[ran])}
        valid = args[4]
        n_kept, n_valid = int(got.kept.sum()), int(valid.sum())
        print(f"  stability_filter {label}: K={valid.shape[0]}, {n_valid} valid, "
              f"{int(ran[1].sum())} return searches ({int((ran[1] & ~got.kept).sum())} "
              f"pruned by them), {int((~ran[1] & valid).sum())} skipped, {n_kept} kept; "
              f"equal {same}")
        if not all(same.values()):
            raise AssertionError(f"stability_filter {label} differs from its plain version: {same}")
        if valid.shape[0] != N_GATHER_WINDOWS or n_kept == 0 or (
                label != "consecutive" and n_kept == n_valid):
            raise AssertionError(f"stability_filter {label}: {n_kept} of {n_valid} kept")
    args = stability_args(*pairs["consecutive"])
    got = stability_search(*args)
    ms = time_ms(lambda: stability_search(*args))
    plain_ms = time_ms(lambda: stability_reference(*args))
    p1 = time_ms(lambda: parent(*args))
    k1 = time_ms(lambda: stability_search(*args))
    k2 = time_ms(lambda: stability_search(*args))
    p2 = time_ms(lambda: parent(*args))
    # the two planes in, the candidates in (desc, xy, valid), the results
    # out; the SSD terms of the searches this data needs
    K = args[4].shape[0]
    n_bytes = 2 * args[0].numel() * 4 + K * (16 + 8 + 1) + K * (1 + 2 + 2 + 16 + 8)
    per_search = MINI_OFFSETS * MINI_TERMS * MINI_TERM_OPS
    n_searches = int(got.ran.sum())
    b_ms, b_by = bound(n_bytes, n_searches * per_search)
    full_ms, full_by = bound(n_bytes, 2 * K * per_search)
    prev, cur = pairs["consecutive"]
    minipatch.filter_frame_candidates(prev, cur)            # warm
    ops_fused = device_ops(lambda: minipatch.filter_frame_candidates(prev, cur))
    fused = minipatch.stability_search
    minipatch.stability_search = parent
    try:
        ops_parent = device_ops(lambda: minipatch.filter_frame_candidates(prev, cur))
    finally:
        minipatch.stability_search = fused
    row = {"K": K, "searches": n_searches, "ms": ms, "plain_ms": plain_ms,
           "parent_ms": [p1, p2], "in_turns_ms": [k1, k2], "bound_ms": b_ms, "bound_by": b_by,
           "bound_all_searches_ms": full_ms, "library_ms": None,
           "device_ops_per_filter": {"fused": ops_fused, "parent": ops_parent}}
    print(f"  stability_filter K={K}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, parent path "
          f"(K8 + eager search) {p1:.4f} / {p2:.4f} ms against the kernel {k1:.4f} / {k2:.4f} "
          f"in turns; bound {b_ms:.6f} ms ({b_by}, {n_searches} searches; "
          f"{full_ms:.6f} ms with all {2 * K}); device ops a filter_frame_candidates call: "
          f"{ops_fused} fused, {ops_parent} on the parent path")
    return (0.0, ms, plain_ms, (b_ms, b_by), None), [row]


def lm_problem(dev, noise=0.3):
    """bench_lm's global case: 16 poses, 2048 points, 8192 sparse
    measurements, 4 cameras, D sized from the data; no edge dropped."""
    from mcptam_tpu_torch.ba.bundle import attach_obs_table, max_obs_per_point
    from mcptam_tpu_torch.ba.problems import build
    from mcptam_tpu_torch.system.mapmaker import _bucket

    prob, cams = build(n_poses=16, n_points=2048, n_cams=4, sparse_k=8192,
                       noise=noise, device=dev)
    D = _bucket(max(int(max_obs_per_point(prob)), 1), (8, 16, 24, 32, 48, 64))
    prob = attach_obs_table(prob, D)
    dropped = int(prob.obs_dropped)
    if dropped != 0:
        raise AssertionError(f"obs table D={D} dropped {dropped} measurements")
    return prob, cams


def schur_system(prob, cams):
    """The damped reduced camera system (Sf, b) of the first LM step."""
    from mcptam_tpu_torch.ba import bundle

    got, orig = {}, bundle.spd_solve

    def grab(A, b):
        got["A"], got["b"] = A.clone(), b.clone()
        return orig(A, b)

    bundle.spd_solve = grab
    try:
        bundle.lm_step(prob, bundle.create_lm_state(prob), cams, fixed_b=True)
    finally:
        bundle.spd_solve = orig
    return got["A"], got["b"]


def random_spd(n: int, gen, dev):
    """Symmetric positive definite (n,n) f32 with condition number 1e4."""
    import torch
    Q, _ = torch.linalg.qr(torch.randn(n, n, generator=gen, dtype=torch.float64))
    A = (Q * torch.logspace(0, 4, n, dtype=torch.float64)) @ Q.T
    return (0.5 * (A + A.T)).to(torch.float32).to(dev)


def backward_error(A, x, b) -> float:
    """Normwise backward error of a solve, in f64."""
    A, x, b = A.double(), x.double(), b.double()
    r = (A @ x - b).abs().max().item()
    return r / (A.abs().sum(1).max().item() * x.abs().max().item()
                + b.abs().max().item())


def check_spd(sf, sf_b, gen):
    """K4 and K5 against the plain solve at n = 96 and 288 (m = 1) on
    random SPD, and at n = 96 on phase 5's Schur matrix.  Returns
    ({kernel: (max_abs_err, ms, plain ms, (bound ms, bound by), library
    ms)} at n = 96, the path's size, and {kernel: [one dict a size]}:
    kernel, plain and bound at n = 96 and 288 beside torch.linalg.solve
    (the plain version, so also the library call) and
    torch.linalg.cholesky + torch.cholesky_solve, a second yardstick the
    port never calls)."""
    import torch
    from mcptam_tpu_torch.core.spd import spd_solve_kernel, spd_solve_reference

    dev = sf.device
    cases = []
    for n in (96, 288):
        cases.append((f"random n={n}", random_spd(n, gen, dev),
                      torch.randn(n, 1, generator=gen).to(dev)))
    cases.append((f"schur n={sf.shape[0]}", sf.contiguous(),
                  sf_b.reshape(-1, 1).contiguous()))
    out, sizes = {}, {}
    for blocked, kname in ((True, "spd_solve_blocked"), (False, "spd_solve_simple")):
        err_abs, times = 0.0, {}
        for label, A, b in cases:
            x = spd_solve_kernel(A, b, blocked)
            x_plain = spd_solve_reference(A, b)
            torch.cuda.synchronize()
            kappa = float(torch.linalg.cond(A.double()))
            d = (x - x_plain).abs().max().item()
            rel = d / max(x_plain.abs().max().item(), 1e-30)
            bwd = backward_error(A, x, b)
            ok = rel <= SPD_TOL if label.startswith("random") else bwd <= SPD_BACKWARD_TOL
            if not (torch.isfinite(x).all() and ok):
                raise AssertionError(f"{kname} {label}: relative error {rel}, backward "
                                     f"error {bwd} (plain {backward_error(A, x_plain, b)}), "
                                     f"kappa {kappa:.3g}")
            err_abs = max(err_abs, d)
            if label.startswith("random"):
                times[A.shape[0]] = (
                    time_ms(lambda: spd_solve_kernel(A, b, blocked)),
                    time_ms(lambda: spd_solve_reference(A, b)),
                    time_ms(lambda: torch.cholesky_solve(b, torch.linalg.cholesky(A))))
            print(f"  {kname} {label}: rel err vs plain {rel:.3g}, backward error "
                  f"{bwd:.3g} (plain {backward_error(A, x_plain, b):.3g}), kappa {kappa:.3g}")
        sizes[kname] = []
        for n, (k_ms, p_ms, chol_ms) in times.items():
            # A, b in, x out; Cholesky n^3/3 and two triangular solves 2 n^2
            b_ms, b_by = bound((n * n + 2 * n) * 4, n ** 3 / 3 + 2 * n * n)
            # the plain version is the library solve, torch.linalg.solve
            sizes[kname].append({"n": n, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                                 "bound_by": b_by, "library_ms": p_ms,
                                 "cholesky_solve_ms": chol_ms})
            print(f"  {kname} n={n} m=1: kernel {k_ms:.4f} ms, plain = torch.linalg.solve "
                  f"{p_ms:.4f} ms, cholesky + cholesky_solve {chol_ms:.4f} ms, bound "
                  f"{b_ms:.6f} ms ({b_by})")
        n96 = sizes[kname][0]
        out[kname] = (err_abs, n96["ms"], n96["plain_ms"], (n96["bound_ms"], n96["bound_by"]),
                      n96["library_ms"])
    return out, sizes


def record_searches(sys_, batch):
    """The arguments of every find_patches call of one process_frames batch
    (the tracker's coarse and fine search of each frame), cloned."""
    import torch
    from mcptam_tpu_torch.ops import batch_patch

    calls, orig = [], batch_patch.find_patches

    def keep(x):
        return x.clone() if isinstance(x, torch.Tensor) else x

    def recorded(*a, **k):
        calls.append((tuple(keep(x) for x in a), {n: keep(v) for n, v in k.items()}))
        return orig(*a, **k)

    batch_patch.find_patches = recorded
    try:
        sys_.process_frames(batch)
        sys_.flush_pipeline()
    finally:
        batch_patch.find_patches = orig
    return calls


def check_search(calls, tcfg=None):
    """K2's fused search against search_patches_reference on a tracked
    frame's coarse (K=60, R=8) and fine (K=1000, R=10) calls (the budgets
    and ranges of ``tcfg``, the default TrackerConfig if None): the real
    packed atlas, templates and predictions.  sum_p and sum_p2 bit-exact,
    region_ok equal; found and the best offset agree on SEARCH_AGREE of the
    pairs and every disagreement is a near-tie; where they agree the
    (15,15) windows are equal and the subpixel refinement lands within
    SUBPIX_TOL.  Timed at both shapes.  Returns the fine row and a row for
    each shape."""
    import torch
    from mcptam_tpu_torch.config import TrackerConfig
    from mcptam_tpu_torch.ops.batch_patch import subpix_refine_region
    from mcptam_tpu_torch.ops.search_kernel import (
        WSZ, search_patches, search_patches_reference,
    )

    tcfg = tcfg or TrackerConfig()
    stages = (("coarse", -(-tcfg.coarse_range // 4), tcfg.coarse_sub_pix_its),
              ("fine", tcfg.fine_range_first, tcfg.fine_sub_pix_its))
    err, sizes = 0.0, []
    for stage, R, its in stages:
        args, kw = next(c for c in calls if c[0][6] == R)
        packed, level_hw, cam, lvl, tmpl, pred = args[:6]
        K, S = cam.shape[0], 2 * R + 1
        box_k = torch.empty((2, K, S, S), device=packed.device)
        box_p = torch.empty_like(box_k)
        fk, pk, sk, ak = search_patches(*args, **kw, box=box_k)
        fp, pp, sp, ap = search_patches_reference(*args, **kw, box=box_p)
        rk, ck = subpix_refine_region(ak, level_hw, lvl, tmpl, pk, its)
        rp, cp = subpix_refine_region(ap, level_hw, lvl, tmpl, pp, its)
        torch.cuda.synchronize()
        if not torch.equal(box_k, box_p):
            raise AssertionError(f"search_patches {stage}: sum_p / sum_p2 differ from the "
                                 f"plain box sums by {(box_k - box_p).abs().max().item()}")
        if not torch.equal(ak["region_ok"], ap["region_ok"]):
            raise AssertionError(f"search_patches {stage}: region_ok differs")
        agree = ((fk == fp) & (pk == pp).all(-1) & (ak["by"] == ap["by"])
                 & (ak["bx"] == ap["bx"]))
        tie = torch.isclose(sk, sp, rtol=SEARCH_TIE, atol=SEARCH_TIE)
        same_win = (ak["win"] == ap["win"]).reshape(K, -1).all(-1)
        both = agree & fk
        conv = both & ck & cp
        sub = (rk - rp)[conv].abs().max().item() if bool(conv.any()) else 0.0
        fin = agree & torch.isfinite(sp)
        e = (sk - sp)[fin].abs().max().item() if bool(fin.any()) else 0.0
        frac, n_found = agree.float().mean().item(), int(fk.sum())
        print(f"  search_patches {stage} K={K} R={R}: agree {frac:.4f}, "
              f"{int((~agree).sum())} near-tie disagreements, found {n_found} "
              f"(plain {int(fp.sum())}), best ZMSSD max |d| {e:.3g}, subpixel max |d| {sub:.3g}")
        if (frac < SEARCH_AGREE or not bool(tie[~agree].all())
                or not bool(same_win[agree].all()) or not sub <= SUBPIX_TOL
                or not torch.equal(ck[both], cp[both]) or n_found == 0):
            raise AssertionError(f"search_patches {stage} disagrees with its plain version: "
                                 f"agree {frac}, non-tie disagreements "
                                 f"{int((~agree & ~tie).sum())}, windows equal "
                                 f"{bool(same_win[agree].all())}, subpixel {sub}")
        err = max(err, e)
        ms_k = time_ms(lambda: search_patches(*args, **kw))
        ms_p = time_ms(lambda: search_patches_reference(*args, **kw))
        G, G2 = S + 8, S + 14
        # in: the region, the template, prediction, camera and level, the
        # exhaustive flag; out: the window, found, region_ok, position,
        # score, offset.  Operations: the cross term's 64 FMAs and ~30 for
        # box sums, score and masks an offset, 22 a row sum
        n_bytes = K * (G2 * G2 * 4 + 64 * 4 + 8 + 16 + 1) + K * (WSZ * WSZ * 4 + 2 + 12 + 16)
        b_ms, b_by = bound(n_bytes, K * (S * S * (2 * 64 + 30) + G * S * 22))
        sizes.append({"stage": stage, "K": K, "R": R, "max_abs_err": e, "agree": frac,
                      "ms": ms_k, "plain_ms": ms_p, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": None})
        print(f"  search_patches {stage} K={K} R={R}: kernel {ms_k:.4f} ms, plain "
              f"{ms_p:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    t = sizes[-1]
    return (err, t["ms"], t["plain_ms"], (t["bound_ms"], t["bound_by"]), None), sizes


def device_ops_per_frame(sys_, batch) -> float:
    """Device operations (kernels, copies, sets) a frame of one
    process_frames batch, from a torch.profiler window."""
    return device_ops(lambda: (sys_.process_frames(batch), sys_.flush_pipeline())) / batch.shape[0]


def check_sbi_resize(dev):
    """make_sbi and K3 on a RESIZE_H x RESIZE_W rig, whose half-sample chain
    ends at 30x47: the card's SBIs (through K1's features, K6/K7 and the
    linear resize) within SBI_TOL of the CPU's, then the tracker's ESM call
    between two frames' SBIs, the kernel against its plain version within
    ESM_TOL."""
    import torch
    from mcptam_tpu_torch.core.se3 import SE3
    from mcptam_tpu_torch.io.synthetic import make_rig, render_rig
    from mcptam_tpu_torch.map.keyframe import make_frame_features
    from mcptam_tpu_torch.ops.sbi import make_sbi
    from mcptam_tpu_torch.ops.sbi_kernel import esm_align, esm_align_all

    cams, cfb = make_rig(C, RESIZE_H, RESIZE_W, spread_deg=25.0, device=dev)
    imgs = [torch.clamp(render_rig(cams, cfb, SE3.exp(torch.tensor(
        traj_tangent(i), dtype=torch.float32, device=dev)), SEED, RESIZE_H, RESIZE_W),
        0, 255).to(torch.uint8) for i in (0, 1)]
    feats = [make_frame_features(im) for im in imgs]
    d = max((f.sbi.cpu() - make_sbi(im.to(torch.float32).cpu())).abs().max().item()
            for f, im in zip(feats, imgs))
    args = (feats[0].sbi, feats[1].sbi, feats[1].sbi_gx, feats[1].sbi_gy)
    se2_k, score_k = esm_align_all(*args, n_iterations=9)
    se2_p, _ = esm_align(*args, n_iterations=9)
    torch.cuda.synchronize()
    e = (se2_k - se2_p).abs().max().item()
    print(f"  make_sbi at {RESIZE_H}x{RESIZE_W}: {tuple(feats[0].sbi.shape)}, card vs CPU "
          f"max |d| {d:.3g}; esm_align_all C={C} 9 iterations: se2 err {e:.3g}, "
          f"se2 {se2_k[0].tolist()}")
    if tuple(feats[0].sbi.shape) != (C, 30, 40) or not d <= SBI_TOL:
        raise AssertionError(f"make_sbi at {RESIZE_H}x{RESIZE_W}: shape "
                             f"{tuple(feats[0].sbi.shape)}, card vs CPU {d}")
    if not e <= ESM_TOL or not (torch.isfinite(se2_k).all() and torch.isfinite(score_k).all()):
        raise AssertionError(f"esm_align_all on the resized SBIs: se2 differs by {e}")


def pad_poses(prob, n_poses: int):
    """The bundle problem placed in an n_poses capacity: fixed identity
    poses without measurements fill the slots, so the reduced camera
    system grows to n = 6 n_poses with unit rows for them."""
    import torch
    from mcptam_tpu_torch.core.se3 import SE3

    extra = n_poses - prob.movable_a.shape[0]
    eye = SE3.identity((extra,), device=prob.movable_a.device)
    return prob.replace(
        pose_a=SE3(R=torch.cat([prob.pose_a.R, eye.R]), t=torch.cat([prob.pose_a.t, eye.t])),
        movable_a=torch.cat([prob.movable_a, torch.zeros_like(prob.movable_a[:1]).expand(extra)]))


def check_spd_global(sf, sf_b, gen):
    """K4's global path at n in SPD_GLOBAL_SIZES on random SPD (relative
    SPD_TOL against the plain solve) and on the Schur matrix of phase 5's
    problem placed in a CAPACITY_MKFS capacity (backward error at most 10x
    the plain solver's).  Timed at every size beside torch.linalg.solve
    (the plain version) and torch.linalg.cholesky + torch.cholesky_solve,
    and at n = SHARED_CAPACITY beside the shared K4 its route takes there.
    Prints the launches a solve enqueues and NB and TILE, as the library
    states them and as the wrapper expects them.  Returns the row at
    n = 6 CAPACITY_MKFS and a row for each size."""
    import torch
    from mcptam_tpu_torch.core.spd import (
        global_launches, global_plan, global_work_floats, route, spd_solve_kernel,
        spd_solve_reference,
    )

    dev = sf.device
    for n in SPD_GLOBAL_SIZES:
        plan = global_plan(n, 1)
        print(f"  spd_solve_blocked_global n={n} plan: {plan}")
        if (plan["launches"], plan["work_floats"]) != (global_launches(n),
                                                       global_work_floats(n, 1)):
            raise AssertionError(f"spd_solve_blocked_global n={n}: the library's plan {plan} "
                                 f"is not the wrapper's ({global_launches(n)} launches, "
                                 f"{global_work_floats(n, 1)} floats)")
    from mcptam_tpu_torch.csrc._build import check, load

    def global_direct(A, b):
        """The global path's C entry point, whatever route() picks for n."""
        n, X = A.shape[0], torch.empty_like(b)
        work = torch.empty(global_work_floats(n, 1), dtype=torch.float32, device=dev)
        check(load().mcptam_spd_solve_global(A.data_ptr(), b.data_ptr(), X.data_ptr(),
                                             work.data_ptr(), n, 1, work.numel(),
                                             torch.cuda.current_stream().cuda_stream),
              "mcptam_spd_solve_global")
        return X

    A = random_spd(SHARED_CAPACITY, gen, dev)
    b = torch.randn(SHARED_CAPACITY, 1, generator=gen).to(dev)
    x, x_plain = global_direct(A, b), spd_solve_reference(A, b)
    rel = ((x - x_plain).abs().max() / x_plain.abs().max()).item()
    if not (torch.isfinite(x).all() and rel <= SPD_TOL):
        raise AssertionError(f"spd_solve_blocked_global n={SHARED_CAPACITY}: relative error {rel}")
    g_ms = time_ms(lambda: global_direct(A, b))
    s_ms = time_ms(lambda: spd_solve_kernel(A, b))
    print(f"  spd_solve_blocked_global n={SHARED_CAPACITY} m=1 (route: "
          f"{route(SHARED_CAPACITY, 1)}): global path {g_ms:.4f} ms, shared K4 {s_ms:.4f} ms, "
          f"rel err vs plain {rel:.3g}")
    cases = [(f"random n={n}", random_spd(n, gen, dev), torch.randn(n, 1, generator=gen).to(dev))
             for n in SPD_GLOBAL_SIZES]
    cases.append((f"schur n={sf.shape[0]}", sf.contiguous(), sf_b.reshape(-1, 1).contiguous()))
    err_abs, sizes = 0.0, []
    for label, A, b in cases:
        n = A.shape[0]
        if route(n, 1) != "spd_solve_blocked_global":
            raise AssertionError(f"spd_solve n={n} does not take the global path")
        x = spd_solve_kernel(A, b)
        x_plain = spd_solve_reference(A, b)
        torch.cuda.synchronize()
        d = (x - x_plain).abs().max().item()
        rel = d / max(x_plain.abs().max().item(), 1e-30)
        bwd, bwd_plain = backward_error(A, x, b), backward_error(A, x_plain, b)
        ok = rel <= SPD_TOL if label.startswith("random") else bwd <= 10 * bwd_plain
        print(f"  spd_solve_blocked_global {label}: rel err vs plain {rel:.3g}, backward "
              f"error {bwd:.3g} (plain {bwd_plain:.3g})")
        if not (torch.isfinite(x).all() and ok):
            raise AssertionError(f"spd_solve_blocked_global {label}: relative error {rel}, "
                                 f"backward error {bwd} (plain {bwd_plain})")
        err_abs = max(err_abs, d)
        if label.startswith("random"):
            k_ms = time_ms(lambda: spd_solve_kernel(A, b))
            p_ms = time_ms(lambda: spd_solve_reference(A, b))
            chol_ms = time_ms(lambda: torch.cholesky_solve(b, torch.linalg.cholesky(A)))
            b_ms, b_by = bound((n * n + 2 * n) * 4, n ** 3 / 3 + 2 * n * n)
            sizes.append({"n": n, "max_abs_err": d, "ms": k_ms, "plain_ms": p_ms,
                          "bound_ms": b_ms, "bound_by": b_by, "library_ms": p_ms,
                          "cholesky_solve_ms": chol_ms, "launches_a_solve": global_launches(n)})
            print(f"  spd_solve_blocked_global n={n} m=1: kernel {k_ms:.4f} ms, plain = "
                  f"torch.linalg.solve {p_ms:.4f} ms, cholesky + cholesky_solve "
                  f"{chol_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    row = next(r for r in sizes if r["n"] == 6 * CAPACITY_MKFS)
    return (err_abs, row["ms"], row["plain_ms"], (row["bound_ms"], row["bound_by"]),
            row["library_ms"]), sizes


def phase_lm(dev, card):
    """Phase 5.  Returns the launches of the K5 run and of the capacity
    run on K4's global path."""
    import torch
    from mcptam_tpu_torch import backend
    from mcptam_tpu_torch.ba.bundle import (
        _residuals_and_jacobians, create_lm_state, lm_run,
    )

    prob, cams = lm_problem(dev)

    def run(st):
        return lm_run(prob, st, cams, 10, fixed_b=True)

    st = create_lm_state(prob)
    for _ in range(2):                      # warm-up
        st = run(st)
    torch.cuda.synchronize()
    st = create_lm_state(prob)
    t0 = time.perf_counter()
    for _ in range(6):
        st = run(st)
    cost_blocked = float(st.cost)           # host read ends the window
    dt = time.perf_counter() - t0
    print(f"lm: {60 / dt:.2f} LM iterations/s ({dt * 1e3 / 60:.3f} ms/iteration, "
          f"16 poses, 2048 points, {prob.m_valid.shape[0]} measurements, "
          f"D={prob.obs_idx.shape[1]}, accepted {int(st.accepted)}/"
          f"{int(st.iterations)}, cost {cost_blocked:.6g}) on {card}")

    # fidelity: 100 iterations on the noiseless problem, same shapes
    probf, camsf = lm_problem(dev, noise=0.0)
    stf = create_lm_state(probf)
    for _ in range(10):
        stf = lm_run(probf, stf, camsf, 10, fixed_b=True)
    e, _, _, _, ok = _residuals_and_jacobians(probf, stf.pose_a, stf.pose_b,
                                              stf.points, camsf)
    fid = float(torch.sum(torch.linalg.vector_norm(e, dim=-1) * ok)
                / torch.clamp(torch.sum(ok), min=1))
    print(f"lm fidelity: mean reprojection error {fid:.3e} px over "
          f"{int(ok.sum())} measurements after 100 iterations")
    if not fid < 1e-3:
        raise AssertionError(f"LM fidelity {fid} px >= 1e-3 px")

    # the timed problem once more on the unblocked kernel (K5)
    os.environ["MCPTAM_SPD_KERNEL"] = "simple"
    try:
        backend.reset_launch_counts()
        st_s = create_lm_state(prob)
        for _ in range(6):
            st_s = lm_run(prob, st_s, cams, 10, fixed_b=True)
        cost_simple = float(st_s.cost)
        launches = backend.kernel_report()["spd_solve_simple"]
    finally:
        os.environ.pop("MCPTAM_SPD_KERNEL")
    rel = abs(cost_simple - cost_blocked) / max(abs(cost_blocked), 1e-30)
    print(f"lm on spd_solve_simple: cost {cost_simple:.6g} vs blocked "
          f"{cost_blocked:.6g} (rel {rel:.3g}, tol {LM_COST_TOL}), "
          f"{launches} launches")
    if not rel <= LM_COST_TOL or launches <= 0:
        raise AssertionError("the K5 LM run disagrees or never launched K5")

    # the timed problem in a CAPACITY_MKFS capacity (n = 384, past K4's
    # shared range), on K4's global path and then on the plain solver, in
    # float64 (the gate) and in float32
    from mcptam_tpu_torch.ba import bundle
    from mcptam_tpu_torch.core.spd import spd_solve_reference

    cap = pad_poses(prob, CAPACITY_MKFS)

    def run_cap():
        st_c = create_lm_state(cap)
        for _ in range(6):
            st_c = lm_run(cap, st_c, cams, 10, fixed_b=True)
        return float(st_c.cost)

    def plain(dtype):
        return lambda A, b: spd_solve_reference(A.to(dtype), b.to(dtype)[:, None])[:, 0].float()

    backend.reset_launch_counts()
    t0 = time.perf_counter()
    cost_global = run_cap()                 # host read ends the window
    dt_global = time.perf_counter() - t0
    launches_global = backend.kernel_report()["spd_solve_blocked_global"]
    costs, orig = {}, bundle.spd_solve
    for dtype in (torch.float64, torch.float32):
        bundle.spd_solve = plain(dtype)
        try:
            costs[dtype] = run_cap()
        finally:
            bundle.spd_solve = orig
    rel = abs(cost_global - costs[torch.float64]) / max(abs(costs[torch.float64]), 1e-30)
    print(f"lm at a {CAPACITY_MKFS}-MKF capacity (n = {6 * CAPACITY_MKFS}): cost "
          f"{cost_global:.7g} on spd_solve_blocked_global vs {costs[torch.float64]:.7g} on the "
          f"plain solver in float64 (rel {rel:.3g}, tol {CAPACITY_COST_TOL}) and "
          f"{costs[torch.float32]:.7g} in float32; unpadded {cost_blocked:.7g}; "
          f"{launches_global} launches; {60 / dt_global:.2f} LM iterations/s "
          f"({dt_global * 1e3 / 60:.3f} ms/iteration) on the global path on {card}")
    if not rel <= CAPACITY_COST_TOL or launches_global <= 0:
        raise AssertionError("the capacity LM run disagrees or never took K4's global path")
    return {"spd_solve_simple": launches, "spd_solve_blocked_global": launches_global}


class GatherShapes:
    """Counts window-gather calls by (K, G, dtype) from its creation until
    stop(): it wraps the name ops/batch_patch.py calls, so the kernel's own
    launch count is untouched."""

    def __init__(self):
        from mcptam_tpu_torch.ops import batch_patch
        self.mod, self.orig, self.seen = batch_patch, batch_patch.gather_windows, {}

        def counted(plane, rows, cols, G):
            key = (int(rows.shape[0]), int(G), str(plane.dtype).replace("torch.", ""))
            self.seen[key] = self.seen.get(key, 0) + 1
            return self.orig(plane, rows, cols, G)

        batch_patch.gather_windows = counted

    def stop(self) -> dict:
        self.mod.gather_windows = self.orig
        return self.seen


def phase_mapping(cams, cfb, cams_sbi, frames, poses, card):
    """Phase 6.  Returns the launch counts of the mapping run."""
    import torch
    from mcptam_tpu_torch import backend
    from mcptam_tpu_torch.config import MapMakerConfig, TrackerConfig
    from mcptam_tpu_torch.core.se3 import SE3
    from mcptam_tpu_torch.io.synthetic import build_groundtruth_map, render_rig
    from mcptam_tpu_torch.map.state import count_mkfs, count_points
    from mcptam_tpu_torch.system.evaluate import ate_rmse
    from mcptam_tpu_torch.system.mapmaker import MM_RUNNING, MapMaker
    from mcptam_tpu_torch.system.system import System

    dev = cfb.t.device
    ms, _ = build_groundtruth_map(
        cams, cfb, H, W, n_per_level=N_PER_LEVEL, max_points=MAX_POINTS,
        max_mkfs=MAX_MKFS, max_meas=MAX_MEAS)
    warm = [torch.clamp(render_rig(cams, cfb, SE3.exp(torch.tensor(
        excursion_tangent(i), dtype=torch.float32, device=dev)), SEED, H, W),
        0, 255).to(torch.uint8) for i in range(N_WARMUP)]
    mm = MapMaker(cams=cams, mcfg=MapMakerConfig(), ba_chunk=BA_CHUNK)
    sys_ = System(cams, cfb, cams_sbi, H, W, tcfg=TrackerConfig(),
                  mcfg=MapMakerConfig(), max_points=MAX_POINTS,
                  max_mkfs=MAX_MKFS, max_meas=MAX_MEAS, mapmaker=mm,
                  pipeline_depth=2 * B)
    sys_.ms, sys_.initialized = ms, True
    sys_.vars["AddingMKFs"] = True
    mm.state = MM_RUNNING
    sys_.tick_every = TICK_EVERY
    # a relocalisation attempt computes its frame's features again
    reloc_calls, reloc_fn = [], sys_._reloc_fn

    def counted_reloc(*a, **k):
        reloc_calls.append(1)
        return reloc_fn(*a, **k)

    sys_._reloc_fn = counted_reloc
    torch.cuda.synchronize()

    backend.reset_launch_counts()
    gathers = GatherShapes()
    t0 = time.perf_counter()
    warm_infos = []
    for i in range(0, N_WARMUP, B):
        warm_infos += sys_.process_frames(torch.stack(warm[i:i + B]))
    warm_infos += sys_.flush_pipeline()
    torch.cuda.synchronize()
    n_added = sum(i.added_mkf for i in warm_infos)
    print(f"mapping warm-up: {N_WARMUP} frames in {time.perf_counter() - t0:.2f} s, "
          f"{n_added} MKFs added, map {int(count_mkfs(sys_.ms))} MKFs / "
          f"{int(count_points(sys_.ms))} points, BA {mm.ba_log}")

    # timed: one full trajectory period, continuing from the warm-up
    mm._idle_ticks = 1
    mm.on_map_changed()
    cursor, by_fid = N_WARMUP, {}
    t0 = time.perf_counter()
    while cursor < N_WARMUP + N_POSES:
        for info in sys_.process_frames(torch.stack(
                [frames[(cursor + j) % N_POSES] for j in range(B)])):
            by_fid[info.frame_id] = info
        cursor += B
    for info in sys_.flush_pipeline():
        by_fid[info.frame_id] = info
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_ba_timed = len(mm.ba_log)
    # then let the map-maker finish what it started (untimed)
    for _ in range(200):
        if (not mm.queue and mm._ba_kind == "none" and mm._local_done
                and mm._global_done):
            break
        sys_.ms = mm.step(sys_.ms)
    torch.cuda.synchronize()
    launches = backend.kernel_report()
    seen = gathers.stop()
    biggest = max(seen, key=lambda k: k[0] * k[1] * k[1] * (4 if k[2] == "float32" else 1))
    epi = max((k for k in seen if k[1] == EPI_WINDOW and k[2] == "uint8"), default=None)
    print(f"mapping: gather_windows calls by (K, G, dtype): {dict(sorted(seen.items()))}; "
          f"largest by bytes {biggest}; largest epipolar source gather {epi}")

    infos = [by_fid[f] for f in sorted(by_fid)]
    if [i.frame_id for i in infos] != list(range(N_WARMUP, N_WARMUP + N_POSES)):
        raise AssertionError("mapping: drained frame ids out of order")
    errs = pose_errors(infos, poses)
    gt34 = [np.concatenate([poses[i.frame_id % N_POSES][0],
                            poses[i.frame_id % N_POSES][1][:, None]], 1)
            for i in infos]
    ate = ate_rmse(np.stack([i.pose for i in infos]), np.stack(gt34))["rmse"]
    mean_found = float(np.mean([i.n_found for i in infos]))
    n_mkfs = int(count_mkfs(sys_.ms))
    print(f"mapping timed pass: {N_POSES / dt:.2f} frames/s "
          f"({dt * 1e3 / N_POSES:.3f} ms/frame, B={B}, ba_chunk={BA_CHUNK}, "
          f"tick_every={TICK_EVERY}) on {card}; mean_found {mean_found:.1f}, "
          f"max_pose_err {max(errs):.6f}, ATE {ate:.3e} m; map {n_mkfs} MKFs / "
          f"{int(count_points(sys_.ms))} points; BA runs (kind, accepted, "
          f"iterations) {mm.ba_log}, {n_ba_timed} finished in the timed window; "
          f"launches {launches}")
    if mean_found < MIN_FOUND or max(errs) >= MAX_POSE_ERR or not ate < MAX_ATE:
        raise AssertionError(f"mapping gates failed: mean_found {mean_found} "
                             f"(>= {MIN_FOUND}), max_pose_err {max(errs)} "
                             f"(< {MAX_POSE_ERR}), ATE {ate} (< {MAX_ATE})")
    if n_mkfs < 2:
        raise AssertionError("mapping: no MKF was integrated")
    if not any(acc > 0 for _, acc, _ in mm.ba_log):
        raise AssertionError(f"mapping: no BA finished with accepted steps: {mm.ba_log}")
    for k in ("fast_frontend", "gather_windows", "search_patches", "esm_align_all",
              "spd_solve_blocked"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the mapping path")
    # K1 once a frame; the batch drain computes the features of each frame
    # it adds as a keyframe or relocalises from once more
    n_adds = sum(i.added_mkf for i in warm_infos) + sum(i.added_mkf for i in infos)
    frames_run = N_WARMUP + N_POSES + n_adds + len(reloc_calls)
    print(f"mapping: fast_frontend {launches['fast_frontend']} launches for {N_WARMUP + N_POSES} "
          f"frames + {n_adds} keyframe adds + {len(reloc_calls)} relocalisation attempts")
    if launches["fast_frontend"] != frames_run:
        raise AssertionError(f"mapping: fast_frontend launched {launches['fast_frontend']} "
                             f"times for {frames_run} feature computations")
    return launches


def panel_frame():
    """Quadrant black/white panels on every camera: imagery the map never
    saw, whose structure survives the SBI blur, so relocalisation rejects
    it (tests/test_system.py:152-169)."""
    yy, xx = np.mgrid[0:H, 0:W]
    panel = (((yy < H // 2) ^ (xx < W // 2)) * 255).astype(np.uint8)
    return np.broadcast_to(panel, (C, H, W)).copy()


def phase_live(cams, cfb, cams_sbi, frames, poses, card):
    """Phase 7.  Returns the launch counts of the live run."""
    import torch
    from mcptam_tpu_torch import backend
    from mcptam_tpu_torch.config import MapMakerConfig, TrackerConfig
    from mcptam_tpu_torch.core.se3 import SE3
    from mcptam_tpu_torch.io.synthetic import render_rig
    from mcptam_tpu_torch.map.state import clone_tree
    from mcptam_tpu_torch.system.evaluate import ate_rmse
    from mcptam_tpu_torch.system import system as system_mod
    from mcptam_tpu_torch.system.mapio import MAP_LEAVES
    from mcptam_tpu_torch.system.system import System

    dev = cfb.t.device
    masks = torch.ones((C, H, W), dtype=torch.bool, device=dev)
    masks[:, H - MASK_BAND:, :] = False

    def new_system():
        s_ = System(cams, cfb, cams_sbi, H, W, tcfg=TrackerConfig(),
                    mcfg=MapMakerConfig(), max_points=MAX_POINTS,
                    max_mkfs=MAX_MKFS, max_meas=MAX_MEAS, masks=masks)
        s_.set_var("GlareMasking", True)
        return s_

    def render(tangent):
        pose = SE3.exp(torch.tensor(tangent, dtype=torch.float32, device=dev))
        img = torch.clamp(render_rig(cams, cfb, pose, SEED, H, W), 0, 255).to(torch.uint8)
        return img, (pose.R.cpu().numpy(), pose.t.cpu().numpy())

    def in_band(feats):
        """Valid candidates inside the masked bottom band, at any level."""
        return sum(int((v & (xy[..., 1] >= (H - MASK_BAND) >> l)).sum())
                   for l, (xy, v) in enumerate(zip(feats.cand_xy, feats.cand_valid)))

    walk = [render(live_tangent(i)) for i in range(N_LIVE_WALK)]
    panel = torch.as_tensor(panel_frame(), device=dev)
    sys_ = new_system()
    torch.cuda.synchronize()
    # keyframe adds that go through the candidate filter: it wraps the name
    # the drain calls, so the kernel's own launch count is untouched
    filtered, filt = [], system_mod.filter_frame_candidates

    def counted_filter(*a, **k):
        filtered.append(1)
        return filt(*a, **k)

    system_mod.filter_frame_candidates = counted_filter

    backend.reset_launch_counts()
    t0 = time.perf_counter()
    kept, band = [], 0            # (info, ground truth) outside the lost stretch
    for img, gt in walk:
        info = sys_.process_frame(img)
        kept.append((info, gt))
        band += in_band(sys_._prev_feats)
        if len(kept) == 1:
            n_boot = info.n_points
            if not sys_.initialized or n_boot < sys_.mcfg.min_map_points:
                raise AssertionError(f"live: bootstrap made {n_boot} points")
    n_added = sum(i.added_mkf for i, _ in kept)
    n_walk_frames = len(kept)
    lost_at = None
    for k in range(N_PANEL_MAX):
        info = sys_.process_frame(panel)
        if info.relocalized:
            raise AssertionError("live: relocalised onto the panel frames")
        if info.lost:
            lost_at = k + 1
            break
    if lost_at is None:
        raise AssertionError(f"live: still tracking after {N_PANEL_MAX} panel frames")
    loss_t = sys_.ts.pose.t.cpu().numpy()
    reloc_at, n_lost_return = None, 0
    for i in range(N_RETURN):
        info = sys_.process_frame(frames[i % N_POSES])
        band += in_band(sys_._prev_feats)
        if reloc_at is None:
            n_lost_return += 1
            if info.relocalized:
                reloc_at = i
            continue
        kept.append((info, poses[i % N_POSES]))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_frames = n_walk_frames + lost_at + N_RETURN
    launches = backend.kernel_report()
    system_mod.filter_frame_candidates = filt

    if reloc_at is None:
        raise AssertionError("live: no frame relocalised after the loss")
    resumed = [i for i, _ in kept[n_walk_frames:]]
    if not resumed or any(i.lost for i in resumed[-4:]):
        raise AssertionError("live: tracking did not resume after relocalisation")
    infos = [i for i, _ in kept]
    gt34 = np.stack([np.concatenate([R, t_[:, None]], 1) for _, (R, t_) in kept])
    ate = ate_rmse(np.stack([i.pose for i in infos]), gt34)["rmse"]
    mean_found = float(np.mean([i.n_found for i in infos]))
    print(f"live: {n_frames} process_frame frames in {dt:.2f} s, {n_frames / dt:.2f} "
          f"frames/s on {card}; bootstrap {n_boot} points, {n_added} MKFs added in "
          f"{n_walk_frames} warm-up frames, lost after {lost_at} panel frames "
          f"{np.linalg.norm(loss_t - poses[0][1]):.3f} m and {LIVE_YAW} rad from "
          f"trajectory pose 0, "
          f"relocalised on return frame {reloc_at}; {len(infos)} frames outside the "
          f"lost stretch: mean_found {mean_found:.1f}, ATE {ate:.3e} m; map "
          f"{infos[-1].n_mkfs} MKFs / {infos[-1].n_points} points; candidates in "
          f"the masked band {band}; {len(filtered)} keyframe adds through the candidate "
          f"filter; launches {launches}")
    if band:
        raise AssertionError(f"live: {band} candidates inside the static mask")
    if n_added < 1:
        raise AssertionError("live: no MKF was added through the candidate filter")
    if mean_found < MIN_FOUND or not ate < MAX_ATE:
        raise AssertionError(f"live gates failed: mean_found {mean_found} (>= {MIN_FOUND}), "
                             f"ATE {ate} (< {MAX_ATE})")
    for k in ("fast_frontend", "gather_windows", "search_patches", "esm_align_all",
              "half_sample", "stability_filter"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the live path")
    # the fused round trip once a filtered add; K8's gather no longer on the path
    if launches["stability_filter"] != len(filtered) or launches["gather_unaligned"]:
        raise AssertionError(f"live: stability_filter launched {launches['stability_filter']} "
                             f"times for {len(filtered)} filtered keyframe adds, "
                             f"gather_unaligned {launches['gather_unaligned']} times")
    if launches["fast_frontend"] != n_frames:      # K1 once a frame
        raise AssertionError(f"live: fast_frontend launched {launches['fast_frontend']} "
                             f"times for {n_frames} frames")

    # the map round trip: settle the map-maker, save, load into a second
    # System, give it the same tracker and scheduler state, and track on
    sys_.flush_pipeline()
    mm = sys_.mapmaker
    for _ in range(200):
        if not mm.queue and mm._ba_kind == "none" and mm._local_done and mm._global_done:
            break
        sys_.ms = mm.step(sys_.ms)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out",
                        "live_session.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    sys_.save(path)
    other = new_system()
    other.load(path)
    for name in MAP_LEAVES:
        a, b = sys_.ms, other.ms
        for part in name.split("."):
            a, b = getattr(a, part), getattr(b, part)
        if not torch.equal(a, b):
            raise AssertionError(f"live: map leaf {name} changed in the round trip")
    other.ts = clone_tree(sys_.ts)
    for name in ("_local_done", "_global_done", "_idle_ticks"):
        setattr(other.mapmaker, name, getattr(mm, name))
    err = 0.0
    for s_ in (sys_, other):
        s_.set_var("AddingMKFs", False)
    for i in range(N_RETURN, N_RETURN + N_RESUME):
        pa = sys_.process_frame(frames[i % N_POSES]).pose
        pb = other.process_frame(frames[i % N_POSES]).pose
        err = max(err, float(np.abs(pa - pb).max()))
    print(f"live map round trip: {len(MAP_LEAVES)} leaves equal; {N_RESUME} frames "
          f"tracked by both systems, poses within {err:.3e}")
    if not err <= RESUME_TOL:
        raise AssertionError(f"live: poses after the map round trip differ by {err}")
    os.remove(path)
    return launches


def app_inputs(root, cams, cfb):
    """Phase 8's inputs under ``root``: phase 7's 24 warm-up frames as a PGM
    dataset directory (timestamps.txt a camera) carrying the rig document
    (save_rig, at full width, with phase 7's bottom mask band as
    masks/cameraN.npy), and the ground truth as (T,6) ln vectors.  Returns
    (dataset dir, ground-truth file)."""
    import torch
    from mcptam_tpu_torch.core.se3 import SE3
    from mcptam_tpu_torch.io.dataset import export_sequence_dir
    from mcptam_tpu_torch.io.rig_config import save_rig
    from mcptam_tpu_torch.io.synthetic import DEFAULT_PARAMS, render_rig

    dev = cfb.t.device
    tangents = np.array([live_tangent(i) for i in range(N_LIVE_WALK)], np.float32)
    frames = np.stack([torch.clamp(render_rig(
        cams, cfb, SE3.exp(torch.as_tensor(v, device=dev)), SEED, H, W), 0, 255
    ).to(torch.uint8).cpu().numpy() for v in tangents], axis=1)       # (C,T,H,W)
    data = os.path.join(root, "dataset")
    export_sequence_dir(data, frames)
    os.makedirs(os.path.join(data, "masks"))
    mask = np.ones((H, W), bool)
    mask[H - MASK_BAND:, :] = False
    names = [f"camera{c + 1}" for c in range(C)]
    for name in names:
        np.save(os.path.join(data, "masks", f"{name}.npy"), mask)
    # make_rig's intrinsics (io/synthetic.py)
    params = DEFAULT_PARAMS.copy()
    params[4], params[5], params[0] = W / 2.0 + 2.0, H / 2.0 + 3.0, 0.28 * W
    save_rig(os.path.join(data, "rig.json"), [params] * C, (W, H), cam_from_base=cfb,
             names=names, masks_rel=[f"masks/{n}.npy" for n in names])
    gt = os.path.join(root, "gt.npy")
    np.save(gt, tangents)
    return data, gt


def run_app(argv, label, card):
    """Run the mcptam app in-process, its output echoed; gate it as a user
    would read it: every frame reported once, in order, none lost, ATE
    under MAX_ATE, an MKF added after bootstrap, the map file, a PLY vertex
    a live point and a valid MKF, an overlay a valid (MKF, camera), and
    every kernel of the live path launched.  Returns (system, infos,
    launch counts)."""
    import contextlib
    import io
    import torch
    from mcptam_tpu_torch import backend
    from mcptam_tpu_torch.apps import mcptam as app
    from mcptam_tpu_torch.apps._common import load_gt_poses
    from mcptam_tpu_torch.system.evaluate import evaluate_run

    args = app.parse_args(argv)
    out = io.StringIO()
    backend.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            system, infos = app.run(args)
        torch.cuda.synchronize()
    finally:
        sys.stdout.write(out.getvalue())
    dt = time.perf_counter() - t0
    launches = backend.kernel_report()
    text = out.getvalue()

    reported = [int(ln.split()[1]) for ln in text.splitlines() if ln.startswith("frame ")]
    ids = [i.frame_id for i in infos]
    if reported != list(range(N_LIVE_WALK)) or ids != reported:
        raise AssertionError(f"app {label}: frames reported {reported}, infos {ids}")
    scores = evaluate_run(infos, load_gt_poses(args.eval_gt))
    ms = system.ms
    n_live = int((ms.points.valid & ~ms.points.bad).sum())
    n_mkfs = int(ms.mkfs.valid.sum())
    n_kf = int(ms.mkfs.kf_valid[ms.mkfs.valid].sum())
    with open(args.export_ply) as f:
        n_vertex = next(int(ln.split()[-1]) for ln in f if ln.startswith("element vertex"))
    n_overlays = len([f for f in os.listdir(args.dump_kfs) if f.endswith(".ppm")])
    n_added = sum(i.added_mkf for i in infos)
    mm = system.mapmaker
    ba_runs = len(mm.ba_log)          # finished; one may still be running
    ba_ran = bool(ba_runs) or mm._ba_kind != "none"
    print(f"app {label}: {len(infos)} frames in {dt:.2f} s ({len(infos) / dt:.2f} frames/s, "
          f"rig and dataset load, replay, map-maker flush and outputs included) on {card}; "
          f"lost {scores['lost_frames']}, ATE {scores['ate']['rmse']:.3e} m, RPE "
          f"{scores['rpe']['trans_rmse']:.3e} m / {scores['rpe']['rot_rmse_deg']:.3e} deg; "
          f"{n_added} MKFs added, map {n_mkfs} MKFs / {n_live} live points, PLY "
          f"{n_vertex} vertices, {n_overlays} overlays, {ba_runs} BAs finished, "
          f"one running at the end: {mm._ba_kind != 'none'}; "
          f"launches {launches}")
    if scores["lost_frames"] or not scores["ate"]["rmse"] < MAX_ATE:
        raise AssertionError(f"app {label}: lost {scores['lost_frames']}, "
                             f"ATE {scores['ate']['rmse']} (< {MAX_ATE})")
    if n_added < 1:
        raise AssertionError(f"app {label}: no MKF added after the bootstrap")
    if not os.path.exists(args.out_map):
        raise AssertionError(f"app {label}: no map file at {args.out_map}")
    if n_vertex != n_live + n_mkfs or n_overlays != n_kf:
        raise AssertionError(f"app {label}: PLY {n_vertex} vertices for {n_live} points + "
                             f"{n_mkfs} MKFs, {n_overlays} overlays for {n_kf} keyframes")
    must = ["fast_frontend", "search_patches", "esm_align_all", "half_sample",
            "gather_windows", "stability_filter"] + (["spd_solve_blocked"] if ba_ran else [])
    for k in must:
        if launches[k] <= 0:
            raise AssertionError(f"app {label}: kernel {k} never launched")
    return system, infos, launches


def phase_app(cams, cfb, card):
    """Phase 8.  Returns the launch counts of the two app runs."""
    import tempfile
    import torch
    from mcptam_tpu_torch.core.se3 import SE3
    from mcptam_tpu_torch.io.synthetic import render_rig
    from mcptam_tpu_torch.map.align import dominant_plane, plane_align_transform
    from mcptam_tpu_torch.map.state import kf_cam_from_world

    dev = cfb.t.device
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as root:
        data, gt = app_inputs(root, cams, cfb)
        total = {}
        for label, extra in (("A", []), ("B", ["--batch", str(B), "--pipeline", "2"])):
            d = os.path.join(root, label)
            argv = ["--video", data, "--eval-gt", gt, "--out-map", f"{d}_map.npz",
                    "--export-ply", f"{d}.ply", "--dump-kfs", f"{d}_kfs", "--fps", "1000",
                    *extra]
            system, _, launches = run_app(argv, label, card)
            if label == "A":
                sys_a = system
                if launches["fast_frontend"] != N_LIVE_WALK:   # K1 once a frame
                    raise AssertionError(f"app A: fast_frontend launched "
                                         f"{launches['fast_frontend']} times for "
                                         f"{N_LIVE_WALK} frames")
            total = {k: total.get(k, 0) + v for k, v in launches.items()}

    # profile_frame on the next frames of the walk: each stage timed to a
    # device synchronise; the first frame warms up, the rest are averaged
    stages = ("kf_downsample", "sbi", "motion", "pvs", "coarse", "fine", "pose",
              "depth", "add")
    rows = []
    for i in range(N_LIVE_WALK, N_LIVE_WALK + N_PROFILE):
        pose = SE3.exp(torch.tensor(live_tangent(i), dtype=torch.float32, device=dev))
        img = torch.clamp(render_rig(cams, cfb, pose, SEED, H, W), 0, 255).to(torch.uint8)
        rows.append(sys_a.profile_frame(img))
    for r in rows:
        if not all(getattr(r, s) > 0 for s in stages):
            raise AssertionError(f"app: profile_frame stage at 0: {r}")
    mean = {s: 1e3 * float(np.mean([getattr(r, s) for r in rows[1:]])) for s in stages}
    total_ms = sum(mean.values())
    print(f"app profile_frame, mean of {N_PROFILE - 1} frames after one warm-up (ms, share) "
          f"on {card}: " + ", ".join(f"{s} {mean[s]:.3f} ({mean[s] / total_ms:.1%})"
                                      for s in stages) + f"; total {total_ms:.3f}")

    img = sys_a.small_image()
    want = (((C + 1) // 2) * H, 2 * W, 3)
    if img is None or img.shape != want or img.dtype != np.uint8:
        raise AssertionError(f"app: small_image {None if img is None else img.shape}, "
                             f"want {want}")

    # the dominant plane: points and poses move together, so every live
    # point's coordinates in every valid MKF camera stay as they were
    def cam_coords(ms):
        live = ms.points.valid & ~ms.points.bad
        kcw = kf_cam_from_world(ms)
        x = torch.einsum("mcij,nj->mcni", kcw.R, ms.points.pos_w[live]) + kcw.t[:, :, None]
        return x[ms.mkfs.kf_valid].reshape(-1, 3)

    # the map as tracked (its points lie on the textured sphere), then with
    # its live points pressed onto the plane y = 0.3, where a plane is found
    for flat in (False, True):
        if flat:
            live = sys_a.ms.points.valid & ~sys_a.ms.points.bad
            sys_a.ms.points.pos_w[live, 1] = 0.3
        before = cam_coords(sys_a.ms)
        ok = sys_a.align_to_dominant_plane()
        after = cam_coords(sys_a.ms)
        rel = float((torch.linalg.vector_norm(after - before, dim=-1)
                     / torch.linalg.vector_norm(before, dim=-1)).max())
        print(f"app: plane alignment of the {'flattened' if flat else 'tracked'} map "
              f"{'done' if ok else 'failed'}; {before.shape[0]} (point, keyframe camera) "
              f"coordinates within {rel:.3e} relative")
        if not rel <= ALIGN_TOL or (flat and not ok):
            raise AssertionError(f"app: alignment ({'done' if ok else 'failed'}) moved "
                                 f"camera-frame coordinates by {rel}")

    # tests/test_align.py's planar cloud (rng 42) on the card: its 80 plane
    # points end at z = 0 (RANSAC's inliers may add an outlier within 0.1)
    pts, valid = planar_cloud(np.random.default_rng(42))
    pts, valid = torch.as_tensor(pts, device=dev), torch.as_tensor(valid, device=dev)
    gen = torch.Generator(device=dev)
    _, _, inlier, _ = dominant_plane(pts, valid, gen.manual_seed(1))
    T, ok = plane_align_transform(pts, valid, gen.manual_seed(1))
    z = float(torch.abs(T.apply(pts)[:N_PLANE, 2]).max())
    print(f"app: plane_align_transform on the planar cloud: ok {bool(ok)}, "
          f"{int(inlier[:N_PLANE].sum())} of its {N_PLANE} plane points among "
          f"{int(inlier.sum())} inliers, their max |z| {z:.3e}")
    if not bool(ok) or not bool(inlier[:N_PLANE].all()) or not z < PLANE_Z_TOL:
        raise AssertionError(f"app: planar cloud not aligned: ok {bool(ok)}, max |z| {z}")
    return total


class ErrorRecords(logging.Handler):
    """A logging handler that keeps the records of ERROR and above."""

    def __init__(self):
        super().__init__(level=logging.ERROR)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def recording_sends(channel) -> list:
    """Wrap ``channel.send``; the list returned gets (action, blob) of every
    message as it went on the wire."""
    sent = []
    send = channel.send

    def recording(action, arrays=None):
        blob = send(action, arrays)
        sent.append((action, blob))
        return blob

    channel.send = recording
    return sent


def wait_for(cond, timeout_s: float, what: str):
    deadline = time.time() + timeout_s
    while not cond():
        if time.time() > deadline:
            raise AssertionError(f"client/server: {what} within {timeout_s:.1f} s")
        time.sleep(0.01)


def wait_for_ba(server, client, client_sent, timeout_s: float):
    """With the server's loop running: the client takes the server's
    messages until the server has every message the client sent, its queue
    is empty, and a BA has finished since this call began."""
    n_ba = len(server.mapmaker.ba_log)

    def done():
        client.ms = client.mapmaker.step(client.ms)
        return (server.channel.stats["msgs_recv"] >= len(client_sent)
                and server.mapmaker.queue_size() == 0
                and len(server.mapmaker.ba_log) > n_ba)

    wait_for(done, timeout_s, "the server's queue did not empty and a BA finish")


def settle(server, server_sent, client, client_sent, timeout_s: float):
    """With the server's loop stopped: run the two sides in turn in this
    thread until the client has nothing more to send.  The server handles
    every message the client sent and ticks until it is idle (an UPDATE
    follows a DELETE); the client takes every message the server sent."""
    deadline = time.time() + timeout_s

    def left():
        return max(deadline - time.time(), 0.0)

    while True:
        wait_for(lambda: server.channel.stats["msgs_recv"] >= len(client_sent), left(),
                 "the client's messages did not arrive")
        while server.spin_once(timeout_ms=0):
            if not left():
                raise AssertionError(f"client/server: the server did not settle "
                                     f"within {timeout_s:.1f} s")
        wait_for(lambda: client.channel.stats["msgs_recv"] >= len(server_sent), left(),
                 "the server's messages did not arrive")
        n = len(client_sent)
        client.ms = client.mapmaker.step(client.ms)
        if len(client_sent) == n:
            return


def client_server_in_process(cams, cfb, cams_sbi, card):
    """Phase 9 (a): a MapServer on a thread, a SystemClient over loopback
    TCP, both at CS_MAX_MKFS, phase 7's warm-up frames one by one.  Returns
    the launch counts."""
    import threading
    import torch
    from mcptam_tpu_torch import backend
    from mcptam_tpu_torch.core.se3 import SE3
    from mcptam_tpu_torch.io.synthetic import render_rig
    from mcptam_tpu_torch.map.state import SRC_TRACKER, create_map_state
    from mcptam_tpu_torch.system import network
    from mcptam_tpu_torch.system.client import SystemClient
    from mcptam_tpu_torch.system.evaluate import evaluate_run
    from mcptam_tpu_torch.system.netcodec import (
        ACTION_ADD, ACTION_INIT, ACTION_UPDATE, message_encodings, unpack_arrays,
    )

    dev = cfb.t.device
    tangents = [live_tangent(i) for i in range(N_LIVE_WALK)]
    poses = [SE3.exp(torch.tensor(v, dtype=torch.float32, device=dev)) for v in tangents]
    frames = [torch.clamp(render_rig(cams, cfb, p, SEED, H, W), 0, 255).to(torch.uint8)
              for p in poses]
    gt = np.stack([np.concatenate([p.R.cpu().numpy(), p.t.cpu().numpy()[:, None]], 1)
                   for p in poses]).astype(np.float64)
    masks = torch.ones((C, H, W), dtype=torch.bool, device=dev)
    masks[:, H - MASK_BAND:] = False

    errors = ErrorRecords()
    net_log = logging.getLogger(network.__name__)
    net_log.addHandler(errors)
    server_ch = network.Channel.serve(0)
    server_sent = recording_sends(server_ch)
    server = network.MapServer(server_ch, cams, create_map_state(
        H, W, C, cfb, max_mkfs=CS_MAX_MKFS))
    lm_chunks, lm_seconds = [], []
    lm_run = server.mapmaker._lm_run

    def counting_lm_run(*a, **k):
        # each chunk timed to the end of its device work
        t = time.perf_counter()
        out = lm_run(*a, **k)
        torch.cuda.synchronize()
        lm_seconds.append(time.perf_counter() - t)
        lm_chunks.append(server.mapmaker.ba_chunk)
        return out

    server.mapmaker._lm_run = counting_lm_run
    stop = threading.Event()
    thread = threading.Thread(target=server.run, args=(stop,), name="map-server")
    client = None
    try:
        backend.reset_launch_counts()
        thread.start()
        client = SystemClient(cams, cfb, cams_sbi, H, W, "127.0.0.1", server_ch.port,
                              max_mkfs=CS_MAX_MKFS, masks=masks)
        client_sent = recording_sends(client.channel)
        t0 = time.perf_counter()
        infos = [client.process_frame(f) for f in frames]
        infos += client.flush_pipeline()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        wait_for_ba(server, client, client_sent, CS_DEADLINE_S)
        t_wait = time.perf_counter() - t0 - dt
        stop.set()
        thread.join(timeout=CS_DEADLINE_S)
        if thread.is_alive():
            raise AssertionError("client/server: the server loop did not stop")
        settle(server, server_sent, client, client_sent, CS_DEADLINE_S)
        torch.cuda.synchronize()
        launches = backend.kernel_report()
        stats = client.channel.stats
    finally:
        stop.set()
        if thread.is_alive():
            thread.join(timeout=CS_DEADLINE_S)
        net_log.removeHandler(errors)
        if client is not None:
            client.close()
        server_ch.close()

    ids = [i.frame_id for i in infos]
    scores = evaluate_run(infos, gt)
    ms = server.ms
    n_server_mkfs = int(ms.mkfs.valid.sum())
    n_tracker = int((ms.meas.valid & (ms.meas.source == SRC_TRACKER)).sum())
    n_added = sum(i.added_mkf for i in infos)
    updates = [blob for action, blob in server_sent if action == ACTION_UPDATE]
    adds = [("ADD" if action == ACTION_ADD else "INIT", len(blob),
             message_encodings(blob)["img0"])
            for action, blob in client_sent if action in (ACTION_ADD, ACTION_INIT)]
    final = unpack_arrays(updates[-1])
    mine = network.map_update_arrays(client.ms)
    differ = [k for k, v in final.items()
              if k.startswith(("pt_", "ms_")) and not np.array_equal(mine[k], v)]
    lm_steps = sum(lm_chunks)
    k4_global = launches["spd_solve_blocked_global"]
    print(f"client/server (a): {len(infos)} frames in {dt:.2f} s ({len(infos) / dt:.2f} "
          f"frames/s over the client's calls, flush included) on {card}; then {t_wait:.2f} s "
          f"until the server's queue was empty and a BA finished; lost "
          f"{scores['lost_frames']}, ATE "
          f"{scores['ate']['rmse']:.3e} m; {n_added} MKFs added on the client, server map "
          f"{n_server_mkfs} MKFs / {int(ms.points.valid.sum())} points / {n_tracker} "
          f"SRC_TRACKER measurements; monitor packets {server.monitor_count}")
    print(f"client/server (a) wire: client -> server {stats['msgs_sent']} messages "
          f"{stats['bytes_sent']} bytes, server -> client {stats['msgs_recv']} messages "
          f"{stats['bytes_recv']} bytes, reconnects {stats['reconnects']}; keyframe messages "
          + ", ".join(f"{kind} {n} bytes ({enc})" for kind, n, enc in adds)
          + f"; {len(updates)} UPDATEs, the last {len(updates[-1])} bytes")
    print(f"client/server (a) server BA: {len(lm_chunks)} chunks, {lm_steps} LM steps, "
          f"{sum(lm_seconds) * 1e3 / max(lm_steps, 1):.3f} ms an LM step (mean, each chunk "
          f"timed to its end), finished BAs {server.mapmaker.ba_log}, K4 global-route launches "
          f"{k4_global} ({k4_global / max(lm_steps, 1):.2f} an LM step), n = {6 * CS_MAX_MKFS}; "
          f"launches {launches}")
    if errors.records:
        raise AssertionError("client/server: the server loop logged "
                             f"{len(errors.records)} exceptions, the first: "
                             f"{errors.records[0].getMessage()}")
    if ids != list(range(N_LIVE_WALK)):
        raise AssertionError(f"client/server: frames reported {ids}")
    if scores["lost_frames"] or not scores["ate"]["rmse"] < MAX_ATE:
        raise AssertionError(f"client/server: lost {scores['lost_frames']}, "
                             f"ATE {scores['ate']['rmse']} (< {MAX_ATE})")
    if n_added < 1 or n_server_mkfs < 2:
        raise AssertionError(f"client/server: {n_added} MKFs added, {n_server_mkfs} on the server")
    if n_tracker <= 0:
        raise AssertionError("client/server: no SRC_TRACKER measurement on the server")
    if server.monitor_count < 1:
        raise AssertionError("client/server: no monitor packet reached the server")
    if differ:
        raise AssertionError(f"client/server: the client's sections differ from the last "
                             f"UPDATE in {differ}")
    must = ["fast_frontend", "search_patches", "esm_align_all", "half_sample", "gather_windows",
            "stability_filter", "spd_solve_blocked_global"]
    for k in must:
        if launches[k] <= 0:
            raise AssertionError(f"client/server: kernel {k} never launched")
    if launches["fast_frontend"] != N_LIVE_WALK:      # K1 once a frame, on the client
        raise AssertionError(f"client/server: fast_frontend launched "
                             f"{launches['fast_frontend']} times for {N_LIVE_WALK} frames")
    return launches


def client_server_apps(cams, cfb, card):
    """Phase 9 (b): the server app and the client app as two processes on
    phase 8's dataset, the server at the default capacity."""
    import select
    import signal
    import tempfile

    root_dir = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root_dir)
    device = cfb.t.device.type
    with tempfile.TemporaryDirectory() as root:
        data, _ = app_inputs(root, cams, cfb)
        rig = os.path.join(data, "rig.json")
        server_log = os.path.join(root, "server.log")
        t0 = time.perf_counter()
        with open(server_log, "w") as log:
            server = subprocess.Popen(
                [sys.executable, "-m", "mcptam_tpu_torch.apps.server", "--rig", rig,
                 "--port", "0", "--device", device], stdout=subprocess.PIPE, stderr=log,
                text=True, env=env, cwd=root_dir)
        try:
            ready, _, _ = select.select([server.stdout], [], [], CS_START_S)
            line = server.stdout.readline() if ready else ""
            if not line.startswith("PORT "):
                raise AssertionError(f"client/server (b): no PORT line from the server "
                                     f"({line!r}, rc {server.poll()})")
            port = int(line.split()[1])
            t1 = time.perf_counter()
            client = subprocess.run(
                [sys.executable, "-m", "mcptam_tpu_torch.apps.client", "--rig", rig,
                 "--video", data, "--server", f"127.0.0.1:{port}", "--fps", "1000",
                 "--device", device],
                capture_output=True, text=True, env=env, cwd=root_dir,
                timeout=CS_CLIENT_TIMEOUT_S)
            dt = time.perf_counter() - t1
        finally:
            server.send_signal(signal.SIGTERM)
            try:
                server_rc = server.wait(timeout=CS_DEADLINE_S)
            except subprocess.TimeoutExpired:
                server.kill()
                server_rc = server.wait()
            server.stdout.close()
        with open(server_log) as f:
            server_err = f.read()
    frames = [ln for ln in client.stdout.splitlines() if ln.startswith("frame ")]
    ids = [int(ln.split()[1]) for ln in frames]
    n_lost = sum("lost=0" not in ln for ln in frames)
    print(f"client/server (b): server up in {t1 - t0:.2f} s; client process {dt:.2f} s for "
          f"{len(frames)} frames ({len(frames) / dt:.2f} frames/s, start-up included) on "
          f"{card}; client rc {client.returncode}, lost {n_lost}; SIGTERM -> server rc "
          f"{server_rc}")
    if client.returncode != 0:
        raise AssertionError(f"client/server (b): client rc {client.returncode}:\n"
                             f"{client.stderr[-3000:]}")
    if ids != list(range(N_LIVE_WALK)) or n_lost:
        raise AssertionError(f"client/server (b): frames {ids}, {n_lost} lost")
    if server_rc != 0 or "MapServer loop iteration failed" in server_err:
        raise AssertionError(f"client/server (b): server rc {server_rc}:\n{server_err[-3000:]}")


def phase_client_server(cams, cfb, cams_sbi, card):
    """Phase 9.  Returns (a)'s launch counts."""
    launches = client_server_in_process(cams, cfb, cams_sbi, card)
    client_server_apps(cams, cfb, card)
    return launches


def scale_lens(params, s: float) -> np.ndarray:
    """A Taylor 9-vector for the image scaled by s: a_i <- a_i s^(1-i) for
    the polynomial's a0, a2, a3, a4, the centre times s."""
    p = np.asarray(params, np.float64).copy()
    p[:4] *= [s, s ** -1, s ** -2, s ** -3]
    p[4:6] *= s
    return p


def calib_pose(v, dev):
    """SE3 of a (t, w) tangent pair, rotation first as the tests build it."""
    import torch
    from mcptam_tpu_torch.core.se3 import SE3, so3_exp

    return SE3(R=so3_exp(torch.tensor(v[3:], dtype=torch.float32, device=dev)),
               t=torch.tensor(v[:3], dtype=torch.float32, device=dev))


class StageTimes:
    """Wraps module functions so each call adds its seconds under a label;
    ``restore`` puts the originals back."""

    def __init__(self):
        self.seconds, self._saved = {}, []

    def wrap(self, mod, name, label):
        fn = getattr(mod, name)
        self._saved.append((mod, name, fn))

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.seconds[label] = self.seconds.get(label, 0.0) + time.perf_counter() - t0
        setattr(mod, name, timed)

    def restore(self):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved = []


def run_main(main, argv):
    """An app's main(argv) in-process, its output echoed: (rc, output)."""
    import contextlib
    import io

    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = main(argv)
    finally:
        sys.stdout.write(out.getvalue())
    return rc, out.getvalue()


def calib_camera_app(root, card, dev):
    """Phase 10 (a): the camera calibrator on six board views."""
    import torch
    from mcptam_tpu_torch.apps import camera_calibrator as app
    from mcptam_tpu_torch.calib import intrinsic, intrinsic_gpu
    from mcptam_tpu_torch.calib.board import render_checkerboard
    from mcptam_tpu_torch.core.camera import make_camera

    h, w = CALIB_CAMERA_H, CALIB_CAMERA_W
    true = np.asarray(CALIB_PARAMS, np.float64)
    cam = make_camera(true, (w, h), device=dev)
    views = os.path.join(root, "views.npy")
    np.save(views, np.stack([
        render_checkerboard(cam, calib_pose(v, dev), h, w, CALIB_SQUARES, CALIB_SQ)
        .to(torch.uint8).cpu().numpy() for v in CALIB_BOARD_POSES]))
    out = os.path.join(root, "camera.json")
    stages = StageTimes()
    stages.wrap(app, "grids_from_images", "detection")
    stages.wrap(intrinsic, "calibrate_linear", "linear solve")
    stages.wrap(intrinsic_gpu, "refine_lm_gpu", "device LM")
    t0 = time.perf_counter()
    try:
        rc, text = run_main(app.main, ["--images", views, "--squares", "8x6",
                                       "--square-size", str(CALIB_SQ), "--out", out])
    finally:
        stages.restore()
    dt = time.perf_counter() - t0
    if rc != 0 or "OK" not in text:
        raise AssertionError(f"camera calibrator: rc {rc}, no OK (RMS >= 0.5 px)")
    with open(out) as f:
        got = np.asarray(json.load(f)["cameras"][0]["params"])
    a0_err = abs(got[0] - true[0]) / true[0]
    c_err = float(np.linalg.norm(got[4:6] - true[4:6]))
    print(f"calibration (a) camera calibrator: {len(CALIB_BOARD_POSES)} views {h}x{w} in "
          f"{dt:.3f} s (" + ", ".join(f"{k} {v:.3f} s" for k, v in stages.seconds.items())
          + f") on {card}; a0 {got[0]:.4f} against {true[0]:.4f} ({a0_err:.2%}), centre "
          f"off by {c_err:.3f} px")
    if not a0_err < CALIB_A0_TOL or not c_err < CALIB_CENTRE_PX:
        raise AssertionError(f"camera calibrator: a0 off by {a0_err:.2%} (< {CALIB_A0_TOL:.0%}), "
                             f"centre by {c_err} px (< {CALIB_CENTRE_PX})")


def rel_errors(rel, true_rel):
    """(rotation, translation) norms of ln(rel true_rel^-1)."""
    err = (rel @ true_rel.inv()).ln().cpu().numpy()
    return float(np.linalg.norm(err[3:])), float(np.linalg.norm(err[:3]))


def calib_pose_app(root, card, dev):
    """Phase 10 (b): the pose calibrator's shared-board path on a 2-camera
    video of the six board poses."""
    import torch
    from mcptam_tpu_torch.apps import pose_calibrator as app
    from mcptam_tpu_torch.calib.board import render_checkerboard
    from mcptam_tpu_torch.core.camera import make_camera
    from mcptam_tpu_torch.core.se3 import SE3

    true = scale_lens(CALIB_PARAMS, CALIB_SCALE)
    cam = make_camera(true, (W, H), device=dev)
    true_rel = calib_pose(CALIB_REL_T + CALIB_REL_W, dev)
    rig = os.path.join(root, "rig.json")
    with open(rig, "w") as f:
        json.dump({"width": W, "height": H, "cameras": [
            {"name": f"camera{c + 1}", "params": [float(x) for x in true]}
            for c in range(2)]}, f)
    frames = np.zeros((2, len(CALIB_BOARD_POSES), H, W), np.uint8)
    for i, v in enumerate(CALIB_BOARD_POSES):
        bfc0 = calib_pose(v, dev)                         # board_from_cam0
        for c, bfc in enumerate((bfc0, bfc0 @ true_rel.inv())):
            frames[c, i] = render_checkerboard(cam, bfc, H, W, CALIB_SQUARES,
                                               CALIB_SQ).to(torch.uint8).cpu().numpy()
    video = os.path.join(root, "views.npz")
    np.savez(video, frames=frames)
    out = os.path.join(root, "rig_cal.json")
    t0 = time.perf_counter()
    rc, text = run_main(app.main, ["--rig", rig, "--video", video, "--squares", "8x6",
                                   "--square-size", str(CALIB_SQ), "--out", out])
    dt = time.perf_counter() - t0
    if rc != 0 or "falling back" in text:
        raise AssertionError(f"pose calibrator: rc {rc}, or it left the shared-board path")
    with open(out) as f:
        v6 = json.load(f)["cameras"][1]["cam_from_base"]
    rot, trans = rel_errors(SE3.exp(torch.tensor(v6, dtype=torch.float32, device=dev)),
                            true_rel)
    print(f"calibration (b) pose calibrator: 2 x {len(CALIB_BOARD_POSES)} views {H}x{W} in "
          f"{dt:.3f} s on {card}; rotation error {rot:.3e}, translation error {trans:.3e} m")
    if not rot < CALIB_ROT_TOL or not trans < CALIB_TRANS_TOL:
        raise AssertionError(f"pose calibrator: rotation error {rot} (< {CALIB_ROT_TOL}), "
                             f"translation error {trans} (< {CALIB_TRANS_TOL})")


def zo_base_pose(i: int, dev):
    """scripts/zero_overlap_drive.py's cam0(base)-from-world at frame i:
    frontal to the board, yawing by -ZO_SEP, translating for baseline."""
    import torch
    from mcptam_tpu_torch.core.se3 import SE3

    centre = np.array([ZO_SQUARES[0] * ZO_SQ / 2, ZO_SQUARES[1] * ZO_SQ / 2, 0.0])
    yaw = -ZO_SEP * np.clip((i - ZO_ROT_START) / (ZO_ROT_END - ZO_ROT_START), 0.0, 1.0)
    Ry = np.array([[np.cos(yaw), 0, -np.sin(yaw)], [0, 1, 0],
                   [np.sin(yaw), 0, np.cos(yaw)]], np.float64)
    pos = np.array([centre[0] - 0.28 + 0.033 * i, centre[1] + 0.012 * i - 0.16,
                    -1.7 + 0.012 * i])
    return SE3(R=torch.as_tensor(Ry, dtype=torch.float32, device=dev),
               t=torch.as_tensor(-Ry @ pos, dtype=torch.float32, device=dev))


def zo_detectable(pose_c, cam, board2) -> bool:
    """The drive's detectability: the board centre within 25 deg of the
    optical axis and every corner projecting 4 px inside the image."""
    import torch
    from mcptam_tpu_torch.core.camera import project

    dev = pose_c.t.device
    centre = torch.tensor([ZO_SQUARES[0] * ZO_SQ / 2, ZO_SQUARES[1] * ZO_SQ / 2, 0.0],
                          device=dev)
    d_c = pose_c.apply(centre).cpu().numpy().astype(np.float64)
    if np.degrees(np.arccos(min(1.0, d_c[2] / max(np.linalg.norm(d_c), 1e-9)))) > 25.0:
        return False
    uv, ok = project(cam, pose_c.apply(board2))
    uvn, okn = uv.cpu().numpy(), ok.cpu().numpy()
    return bool((okn & (uvn[:, 0] > 4) & (uvn[:, 0] < W - 4)
                 & (uvn[:, 1] > 4) & (uvn[:, 1] < H - 4)).all())


class CallRecorder:
    """Wraps module functions and keeps clones of the arguments they are
    called with, as (tag, args, kwargs) under a label: every call while
    ``on``, or, for a function wrapped with ``first=N``, the first call of
    each argument shape and ``tag``, up to N of them.  Recording launches
    nothing; ``restore`` puts the originals back."""

    def __init__(self):
        self.calls, self.on, self.tag, self._saved = {}, False, "", []

    @staticmethod
    def keep(x):
        import torch
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, (list, tuple)):
            return type(x)(CallRecorder.keep(v) for v in x)
        if isinstance(x, dict):
            return {k: CallRecorder.keep(v) for k, v in x.items()}
        return x

    @staticmethod
    def shape_key(x):
        import torch
        if isinstance(x, torch.Tensor):
            return (tuple(x.shape), str(x.dtype))
        if isinstance(x, (list, tuple)):
            return tuple(CallRecorder.shape_key(v) for v in x)
        if isinstance(x, dict):
            return tuple((k, CallRecorder.shape_key(v)) for k, v in sorted(x.items()))
        return x if isinstance(x, (int, float, bool, str, type(None))) else type(x).__name__

    def wrap(self, mod, name, label, first=0):
        fn = getattr(mod, name)
        self._saved.append((mod, name, fn))
        calls, keys = self.calls.setdefault(label, []), set()

        def recorded(*a, **k):
            if first:
                key = (self.tag, self.shape_key(a), self.shape_key(k))
                if key not in keys and len(keys) < first:
                    keys.add(key)
                    calls.append((self.tag, self.keep(a), self.keep(k)))
            elif self.on:
                calls.append((self.tag, self.keep(a), self.keep(k)))
            return fn(*a, **k)
        setattr(mod, name, recorded)

    def restore(self):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved = []


def hold_calibration_kernels(rec, tcfg):
    """Phase 10 (c)'s kernels against their plain versions on the card, on
    the arguments ``rec`` kept from the session: the last frame's K1 (the
    two cameras' pyramid), half-samples, fused searches (coarse K =
    tcfg.coarse_max, fine K = tcfg.max_patches_per_frame, each on the
    camera's call that finds the most) and K3 (C = 2),
    the first ZO_HOLDS window gathers of distinct shapes, and K4 on
    the first Schur system of each size the bundles solved (the frames'
    BA, calib_init's and calib_step's), each beside random SPD of its n.
    Phase 3's tolerances: K1, K2's gather, K6/K7 exact; the search as
    ``check_search``; K3 within ESM_TOL; K4 within SPD_BACKWARD_TOL
    backward error on the Schur systems and SPD_TOL relative on random
    SPD.  Returns {kernel: [row, ...]}, each row tagged with the phase."""
    import torch
    from mcptam_tpu_torch.core.spd import route, spd_solve, spd_solve_reference
    from mcptam_tpu_torch.ops.gather_kernel import gather_windows, gather_windows_reference
    from mcptam_tpu_torch.ops.search_kernel import search_patches

    rows = {}

    def add(kernel, row):
        rows.setdefault(kernel, []).append({"phase": "calibration", **row})

    print("calibration (c) kernels against their plain versions at the session's shapes:")
    for _, (pyr,), _ in rec.calls["fast_frontend"]:
        err, ms, plain_ms, (b_ms, b_by), _ = hold_fast(list(pyr))
        add("fast_frontend", {"shape": [list(p.shape) for p in pyr], "max_abs_err": err,
                              "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                              "bound_by": b_by, "library_ms": None})
        print(f"  fast_frontend levels {[tuple(p.shape) for p in pyr]}: exact, kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")

    halves = sorted((a[0] for _, a, _ in rec.calls["half_sample"]), key=lambda x: -x.numel())
    _, ms, plain_ms, (b_ms, b_by), lib_ms = hold_half_sample(halves)
    add("half_sample", {"shape": list(halves[0].shape), "calls_held": len(halves),
                        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": lib_ms})
    print(f"  half_sample: {len(halves)} calls exact, shapes "
          f"{sorted({tuple(x.shape) for x in halves}, reverse=True)}; at "
          f"{tuple(halves[0].shape)} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, avg_pool2d "
          f"{lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")

    searches = [(a, k) for _, a, k in rec.calls["search_patches"]]
    # each stage is held on the kept call that finds the most
    searches.sort(key=lambda c: -int(search_patches(*c[0], **c[1])[0].sum()))
    _, search_rows = check_search(searches, tcfg)
    for r in search_rows:
        add("search_patches", r)

    _, esm_rows = hold_esm([(a, k.get("n_iterations", 9))
                            for _, a, k in rec.calls["esm_align_all"]])
    for r in esm_rows:
        add("esm_align_all", r)

    gathers = rec.calls["gather_windows"]
    for _, (pl, rows_, cols, G), _ in gathers:
        got, ref = gather_windows(pl, rows_, cols, G), gather_windows_reference(pl, rows_, cols, G)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"gather_windows {pl.dtype} K={rows_.shape[0]} G={G} differs")
    _, (pl, rows_, cols, G), _ = max(gathers, key=lambda c: c[1][1].numel() * c[1][3] ** 2)
    K = rows_.shape[0]
    ms = time_ms(lambda: gather_windows(pl, rows_, cols, G))
    plain_ms = time_ms(lambda: gather_windows_reference(pl, rows_, cols, G))
    b_ms, b_by = bound(K * G * G * pl.element_size() * 2 + K * 2 * 8, 0)
    add("gather_windows", {"K": K, "G": G, "dtype": str(pl.dtype).replace("torch.", ""),
                           "calls_held": len(gathers), "max_abs_err": 0.0, "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                           "library_ms": None})
    print(f"  gather_windows: {len(gathers)} calls exact, (K, G, dtype) "
          f"{[(c[1][1].shape[0], c[1][3], str(c[1][0].dtype)) for c in gathers]}; at K={K} "
          f"G={G} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")

    gen = torch.Generator().manual_seed(13)
    timed = set()
    for tag, (A, b), _ in rec.calls["spd_solve"]:
        n, dev = A.shape[0], A.device
        B = b.reshape(n, -1)
        rA, rb = random_spd(n, gen, dev), torch.randn(n, 1, generator=gen).to(dev)
        x, x_plain = spd_solve(A, B), spd_solve_reference(A, B)
        rx, rx_plain = spd_solve(rA, rb), spd_solve_reference(rA, rb)
        torch.cuda.synchronize()
        bwd, bwd_plain = backward_error(A, x, B), backward_error(A, x_plain, B)
        d = (rx - rx_plain).abs().max().item()
        rel = d / max(rx_plain.abs().max().item(), 1e-30)
        kappa = float(torch.linalg.cond(A.double()))
        print(f"  spd_solve n={n} ({route(n, B.shape[1])}), the first Schur system of {tag}: "
              f"backward error {bwd:.3g} (plain {bwd_plain:.3g}), kappa {kappa:.3g}; random "
              f"SPD n={n}: rel err vs plain {rel:.3g}")
        if not (torch.isfinite(x).all() and bwd <= SPD_BACKWARD_TOL
                and torch.isfinite(rx).all() and rel <= SPD_TOL):
            raise AssertionError(f"spd_solve n={n} ({tag}): Schur backward error {bwd} "
                                 f"(<= {SPD_BACKWARD_TOL}; plain {bwd_plain}), random SPD "
                                 f"relative error {rel} (<= {SPD_TOL})")
        row = {"n": n, "system": tag, "route": route(n, B.shape[1]), "max_abs_err": d,
               "backward_error": bwd, "plain_backward_error": bwd_plain}
        if n not in timed:
            timed.add(n)
            k_ms = time_ms(lambda: spd_solve(A, B))
            p_ms = time_ms(lambda: spd_solve_reference(A, B))
            chol_ms = time_ms(lambda: torch.cholesky_solve(B, torch.linalg.cholesky(rA)))
            b_ms, b_by = bound((n * n + 2 * n) * 4, n ** 3 / 3 + 2 * n * n)
            row.update({"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": p_ms, "cholesky_solve_ms": chol_ms})
            print(f"  spd_solve n={n} m={B.shape[1]}: kernel {k_ms:.4f} ms, plain = "
                  f"torch.linalg.solve {p_ms:.4f} ms, cholesky + cholesky_solve {chol_ms:.4f} "
                  f"ms, bound {b_ms:.6f} ms ({b_by})")
        add(route(n, B.shape[1]), row)
    return rows


def camera_margins(tracked, running, C, tcfg):
    """How close each camera of phase 10 (c) came to being stopped, from
    every tracking call of the session's own trackers (``tracked``: frame,
    cam_active, quality, lost, found and attempted per camera) and the
    session's running flags after each frame: frames tracked and GOOD, the
    frames that were not, the peak of the session's streak of frames not
    GOOD against the ZO_STOP_STREAK that stops a camera, the stops, and the
    found fraction and count against the tracker's GOOD and BAD thresholds
    over every GOOD frame and over the last ZO_MARGIN_FRAMES tracked.
    Prints a line a camera and returns the margins."""
    from mcptam_tpu_torch.tracker.tracker import QUALITY_GOOD

    out = []
    for c in range(C):
        rec = [(i, int(q) == QUALITY_GOOD and not bool(lost), float(f[c]), float(at[c]))
               for i, ca, q, lost, f, at in tracked if int(ca.long().argmax()) == c]
        streak = peak = 0
        for _, good, _, _ in rec:       # calib/pose_calib.py::process_frame's count
            streak = 0 if good else streak + 1
            peak = max(peak, streak)
            streak = 0 if streak >= ZO_STOP_STREAK else streak
        good = [r for r in rec if r[1]]
        last = rec[-ZO_MARGIN_FRAMES:]
        m = {"camera": c, "tracked": len(rec), "good": len(good),
             "first_frame": rec[0][0] if rec else None,
             "not_good_frames": [r[0] for r in rec if not r[1]], "streak_peak": peak,
             "stopped": sum(1 for a, b in zip(running, running[1:]) if a[c] and not b[c]),
             "good_frac_min": min((r[2] / max(r[3], 1.0) for r in good), default=None),
             "good_found_min": min((r[2] for r in good), default=None),
             "last_frac_min": min((r[2] / max(r[3], 1.0) for r in last), default=None),
             "last_found_min": min((r[2] for r in last), default=None)}
        out.append(m)
        print(f"calibration (c) camera {c} margin: tracked {m['tracked']} frames from frame "
              f"{m['first_frame']}, GOOD on {m['good']}, not GOOD at frames "
              f"{m['not_good_frames']}; streak of frames not GOOD peaked at "
              f"{m['streak_peak']} of the {ZO_STOP_STREAK} that stop a camera, stopped "
              f"{m['stopped']} times; found/attempted min {m['good_frac_min']} over GOOD "
              f"frames, {m['last_frac_min']} over the last {ZO_MARGIN_FRAMES} (GOOD above "
              f"{tcfg.quality_good}, BAD below {tcfg.quality_bad}); found min "
              f"{m['good_found_min']} over GOOD frames, {m['last_found_min']} over the last "
              f"{ZO_MARGIN_FRAMES} (BAD below {tcfg.min_patches_per_frame})")
    return out


def calib_zero_overlap(card, dev, large_point_test=True):
    """Phase 10 (c): PoseCalibSession on the zero-overlap rig, then its
    kernels held against their plain versions at the session's shapes.
    ``large_point_test`` is the map-maker's (the drive turns it off only
    because its 128x96 frames leave levels >= 2 nearly featureless; at full
    size it holds).  Returns the launch counts of the session's frames and
    final solves, and the kernels' rows."""
    import torch
    from mcptam_tpu_torch import backend
    from mcptam_tpu_torch.ba import bundle
    from mcptam_tpu_torch.calib import pose_calib
    from mcptam_tpu_torch.calib.board import inner_corner_points
    from mcptam_tpu_torch.config import MapMakerConfig, TrackerConfig
    from mcptam_tpu_torch.core.camera import make_camera, project, stack_cameras
    from mcptam_tpu_torch.core.se3 import SE3
    from mcptam_tpu_torch.io.synthetic import make_sbi_cams, render_rig_board
    from mcptam_tpu_torch.map import keyframe
    from mcptam_tpu_torch.ops import batch_patch, pyramid, sbi
    from mcptam_tpu_torch.tracker import tracker

    params = scale_lens(ZO_PARAMS, ZO_SCALE)
    cam = make_camera(params, (W, H), device=dev)
    cams = stack_cameras([cam, cam])
    true_rel = calib_pose(ZO_REL_T + ZO_REL_W, dev)
    true_cfb = SE3(R=torch.stack([torch.eye(3, device=dev), true_rel.R]),
                   t=torch.stack([torch.zeros(3, device=dev), true_rel.t]))
    board2 = inner_corner_points(ZO_SQUARES, ZO_SQ).reshape(-1, 3)[:, :2]
    board3 = torch.as_tensor(np.concatenate([board2, np.zeros((len(board2), 1))], 1),
                             dtype=torch.float32, device=dev)

    def cam_pose(i, c):
        return zo_base_pose(i, dev) if c == 0 else true_rel @ zo_base_pose(i, dev)

    detectable = np.array([[zo_detectable(cam_pose(i, c), cam, board3) for c in range(2)]
                           for i in range(ZO_FRAMES)])
    if np.any(detectable.all(1)) or not detectable.any(0).all():
        raise AssertionError(f"zero-overlap scene: board views {detectable.sum(0)}, "
                             f"{int(detectable.all(1).sum())} simultaneous")
    tcfg = TrackerConfig(max_patches_per_frame=300, coarse_max=30,
                         max_ssd_per_pixel=500.0)   # the drive's calibration-mode budget
    session = pose_calib.PoseCalibSession(
        cams=cams, cams_sbi=make_sbi_cams(cams, H, W), params9=[params, params],
        board_pts2=board2, H=H, W=W, max_points=1024, max_mkfs=ZO_MAX_MKFS,
        max_meas=8192, tcfg=tcfg, mcfg=MapMakerConfig(large_point_test=large_point_test),
        max_scaled_kf_dist=ZO_KF_DIST)

    lm_calls, tracked, running, frame = [], [], [], [0]
    lm_run, track = pose_calib.lm_run, pose_calib.track_frame

    def recorded(prob, st, cams_, n_steps, *a, **k):
        lm_calls.append((6 * (prob.movable_a.shape[0] + prob.movable_b.shape[0]), n_steps))
        return lm_run(prob, st, cams_, n_steps, *a, **k)

    def tracking(ts, *a, **k):
        ts_new, res = track(ts, *a, **k)
        if any(ts is t for t in session.trackers):     # not a twin-arbitration probe
            tracked.append((frame[0], k["cam_active"], res.quality, res.lost,
                            res.num_found, res.num_attempted))
        return ts_new, res

    rec = CallRecorder()
    rec.wrap(keyframe, "fast_frontend_levels", "fast_frontend")
    rec.wrap(pyramid, "half_sample", "half_sample")
    rec.wrap(sbi, "half_sample", "half_sample")
    rec.wrap(batch_patch, "find_patches", "search_patches")
    rec.wrap(tracker, "esm_align_all", "esm_align_all")
    rec.wrap(batch_patch, "gather_windows", "gather_windows", first=ZO_HOLDS)
    rec.wrap(bundle, "spd_solve", "spd_solve", first=ZO_HOLDS)
    rng = np.random.default_rng(11)
    pose_calib.lm_run, pose_calib.track_frame = recorded, tracking
    backend.reset_launch_counts()
    try:
        t_frames, rec.tag = 0.0, "the frames' BA"
        for i in range(ZO_FRAMES):
            images = render_rig_board(cams, true_cfb, zo_base_pose(i, dev), SEED, H, W,
                                      ZO_SQUARES, ZO_SQ)
            detections = {}
            for c in range(2):
                if detectable[i, c]:
                    uv, ok = project(cam, cam_pose(i, c).apply(board3))
                    uvn = uv.cpu().numpy() + rng.normal(size=(len(board2), 2)) * ZO_NOISE_PX
                    okn = ok.cpu().numpy()
                    detections[c] = (uvn[okn], np.nonzero(okn)[0])
            frame[0], rec.on = i, i == ZO_FRAMES - 1     # the last frame's calls are kept
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            session.process_frame(images, detections)
            torch.cuda.synchronize()
            t_frames += time.perf_counter() - t0
            running.append(list(session.running))
        n_frame_calls, rec.on = len(lm_calls), False
        t0 = time.perf_counter()
        rec.tag = "calib_init"
        session.calib_init()
        rec.tag = "calib_step"
        session.calib_step(40)
        torch.cuda.synchronize()
        t_final = time.perf_counter() - t0
    finally:
        pose_calib.lm_run, pose_calib.track_frame = lm_run, track
        rec.restore()
    launches = backend.kernel_report()

    rot, trans = rel_errors(session.cam_from_base[1], true_rel)
    groups_full = sum(1 for g in session.sync_groups if len(g) == 2)
    n_mkfs = int(session.ms.mkfs.valid.sum())
    sizes = sorted({n for n, _ in lm_calls})
    print(f"calibration (c) zero-overlap session: {ZO_FRAMES} frames {H}x{W} at "
          f"{ZO_FRAMES / t_frames:.3f} frames/s ({t_frames * 1e3 / ZO_FRAMES:.3f} ms/frame), "
          f"calib_init + calib_step(40) {t_final:.3f} s, on {card}; running {session.running}, "
          f"board views {detectable.sum(0).tolist()}, {n_mkfs} MKFs, "
          f"{len(session.sync_groups)} sync groups ({groups_full} with both cameras, "
          f"{len(session.groups)} kept), BA LM steps {sum(n for _, n in lm_calls[:n_frame_calls])} "
          f"in {n_frame_calls} chunks + final {[n for _, n in lm_calls[n_frame_calls:]]}, "
          f"Schur sizes n = {sizes}; rotation error {rot:.3e}, translation error "
          f"{trans:.3e} m; launches {launches}")
    camera_margins(tracked, running, session.C, tcfg)
    rows = hold_calibration_kernels(rec, tcfg)
    if session.running != [True, True] or groups_full <= 0:
        raise AssertionError(f"zero-overlap session: running {session.running}, "
                             f"{groups_full} groups with both cameras")
    if not rot < ZO_ROT_TOL or not trans < ZO_TRANS_TOL:
        raise AssertionError(f"zero-overlap session: rotation error {rot} (< {ZO_ROT_TOL}), "
                             f"translation error {trans} (< {ZO_TRANS_TOL})")
    if launches["fast_frontend"] != ZO_FRAMES:     # K1 once a frame
        raise AssertionError(f"calibration: fast_frontend launched "
                             f"{launches['fast_frontend']} times for {ZO_FRAMES} frames")
    for k in ("search_patches", "esm_align_all", "half_sample", "gather_windows",
              "spd_solve_blocked"):
        if launches[k] <= 0:
            raise AssertionError(f"calibration: kernel {k} never launched")
    return launches, rows


def phase_calibration(card, dev):
    """Phase 10.  Returns (c)'s launch counts and its kernels' rows."""
    import tempfile

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as root:
        calib_camera_app(root, card, dev)
        calib_pose_app(root, card, dev)
    return calib_zero_overlap(card, dev)


def planar_cloud(rng, n_plane=N_PLANE, n_out=20, N=128):
    """tests/test_align.py's tilted plane with outliers, padded to N slots."""
    n = np.array([0.2, -0.3, 0.93])
    n /= np.linalg.norm(n)
    c = np.array([0.5, -0.2, 2.0])
    u = np.cross(n, [1.0, 0, 0])
    u /= np.linalg.norm(u)
    v = np.cross(n, u)
    a = rng.normal(size=(n_plane, 2))
    pts = np.zeros((N, 3), np.float32)
    pts[:n_plane] = c + a[:, :1] * u + a[:, 1:] * v + rng.normal(size=(n_plane, 3)) * 0.002
    pts[n_plane:n_plane + n_out] = c + rng.normal(size=(n_out, 3)) * 2.0
    valid = np.zeros(N, bool)
    valid[:n_plane + n_out] = True
    return pts, valid


def parallel_inputs(cams, cfb, cams_sbi, frames, dev):
    """Phase 11's inputs: phase 5's LM problem with its observation table,
    the same in a 64-MKF capacity and without a table, a ground-truth map
    into which one MKF (the frame at excursion pose PAR_MKF_POSE) was
    integrated, and the arguments of that integration's epipolar call
    with the most wanted candidates (Q divisible by PAR_WORLD)."""
    import torch
    from mcptam_tpu_torch.config import MapMakerConfig, TrackerConfig
    from mcptam_tpu_torch.core.se3 import SE3
    from mcptam_tpu_torch.io.synthetic import build_groundtruth_map, render_rig
    from mcptam_tpu_torch.map import epipolar
    from mcptam_tpu_torch.map.keyframe import make_frame_features
    from mcptam_tpu_torch.map.mapmaker_core import integrate_mkf_device
    from mcptam_tpu_torch.tracker.tracker import create_tracker_state

    prob, lm_cams = lm_problem(dev)
    ms, _ = build_groundtruth_map(
        cams, cfb, H, W, n_per_level=N_PER_LEVEL, max_points=MAX_POINTS,
        max_mkfs=MAX_MKFS, max_meas=MAX_MEAS)
    pose = SE3.exp(torch.tensor(excursion_tangent(PAR_MKF_POSE), dtype=torch.float32,
                                device=dev))
    img = torch.clamp(render_rig(cams, cfb, pose, SEED, H, W), 0, 255).to(torch.uint8)
    best, match = {}, epipolar.epipolar_match

    def recorded(ms_, cams_, *args, **kw):
        cand = args[:7]                       # (src_mkf, ..., xy_level, want)
        opts = dict(zip(("max_ssd", "n_hypotheses", "corner_ambiguity"), args[7:]), **kw)
        n_want = int(cand[-1].sum())
        if cand[-1].shape[0] % PAR_WORLD == 0 and n_want > best.get("n_want", -1):
            best.update(n_want=n_want, cand=tuple(x.clone() for x in cand), kw=opts)
        return match(ms_, cams_, *args, **kw)

    epipolar.epipolar_match = recorded
    try:
        ms, _, _, _ = integrate_mkf_device(ms, cams, make_frame_features(img), pose,
                                           mcfg=MapMakerConfig(),
                                           cap_per_level=EPI_CAP_PER_LEVEL)
    finally:
        epipolar.epipolar_match = match
    return dict(cams=cams, cams_sbi=cams_sbi, ms=ms, frames=frames[:PAR_TRACK_FRAMES],
                prob=prob, cap=pad_poses(prob, CAPACITY_MKFS), lm_cams=lm_cams,
                prob_nt=prob.replace(obs_idx=None, obs_valid=None, obs_dropped=None),
                epi=best["cand"], epi_kw=best["kw"], tcfg=TrackerConfig(),
                ts=create_tracker_state(C, device=dev))


def _to(tree, dev):
    """A tree of dataclasses, tuples, lists and dicts with its tensors on
    ``dev``."""
    import dataclasses
    import torch
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _to(getattr(tree, f.name), dev)
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, dev) for v in tree)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def parallel_drive(inp, mesh=None):
    """Phase 11's functions on ``inp``: sharded over ``mesh``, or the
    unsharded port functions for mesh None.  Returns (results on the CPU,
    {function: seconds}, {LM run: the Schur systems it solved, as (sha256
    of the matrix, matrix, rhs), the matrix and rhs of the first step
    only})."""
    import hashlib
    import torch
    from mcptam_tpu_torch.ba import bundle
    from mcptam_tpu_torch.ba.bundle import create_lm_state, lm_run
    from mcptam_tpu_torch.map.epipolar import epipolar_match
    from mcptam_tpu_torch.map.keyframe import make_frame_features
    from mcptam_tpu_torch.parallel import mesh as M
    from mcptam_tpu_torch.tracker.tracker import track_frame

    out, secs, schur = {}, {}, {}
    on_card = inp["frames"][0].is_cuda
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        r = fn()
        sync()
        secs[name] = time.perf_counter() - t0
        out[name] = _to(r, "cpu")
        return r

    if mesh is None:
        features = make_frame_features
        ms = inp["ms"]

        def track(ts, feats):
            return track_frame(ts, ms, inp["cams"], inp["cams_sbi"], feats, inp["tcfg"])

        def lm(key, steps):
            prob = inp[key]
            st = create_lm_state(prob)
            return lm_run(prob, st, inp["lm_cams"], steps, fixed_b=key != "prob_nt")
        epi = epipolar_match
    else:
        features = M.sharded_frame_features(mesh, inp["frames"][0])[0]
        tracker, ms = M.sharded_track_frame(mesh, inp["ms"], inp["cams"], inp["cams_sbi"],
                                            inp["tcfg"])

        def track(ts, feats):
            return tracker(ts, ms, feats)

        def lm(key, steps):
            if key == "prob_nt":
                return M.sharded_lm_run(mesh, inp[key], inp["lm_cams"], steps)[0]
            return M.sharded_lm_run_soa(mesh, inp[key], inp["lm_cams"], steps)[0]
        epi = M.sharded_epipolar_match(mesh)

    def frames_tracked():
        ts, results = inp["ts"], []
        for img in inp["frames"]:
            ts, res = track(ts, features(img))
            results.append((ts.pose, res))
        return results

    timed("frame_features", lambda: features(inp["frames"][0]))
    timed("track_frame", frames_tracked)
    timed("epipolar_match", lambda: epi(inp["ms"], inp["cams"], *inp["epi"], **inp["epi_kw"]))
    solve = bundle.spd_solve
    for key in ("prob", "cap"):
        for tag, steps in (("first", 1), ("", PAR_LM_STEPS)):
            kept = schur.setdefault(f"{key}{tag}", [])

            def keeping(A, b, kept=kept):
                kept.append((A.clone(), b.clone()))   # no host sync inside the run
                return solve(A, b)

            bundle.spd_solve = keeping
            try:
                timed(f"lm_{key}{tag}", lambda: lm(key, steps))
            finally:
                bundle.spd_solve = solve
    timed("lm_scatter", lambda: lm("prob_nt", PAR_SCATTER_STEPS))
    schur = {run: [(hashlib.sha256(A.cpu().numpy().tobytes()).hexdigest(),
                    A.cpu() if i == 0 else None, b.cpu() if i == 0 else None)
                   for i, (A, b) in enumerate(kept)] for run, kept in schur.items()}
    return out, secs, schur


def parallel_rank(rank: int, world: int, root: str, dev_type: str):
    """One rank of phase 11 (b): a process on cuda:0 (or the CPU, for a
    rehearsal) in a gloo group over a file store under ``root``; runs
    ``parallel_drive`` on the inputs the phase saved there and saves what
    it got."""
    import pickle
    import traceback
    import torch
    import torch.distributed as dist

    try:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import mcptam_tpu_torch  # noqa: F401  (sets the TF32 flags)
        from mcptam_tpu_torch import backend
        from mcptam_tpu_torch.csrc._build import load
        from mcptam_tpu_torch.parallel import mesh as M

        dev = torch.device("cuda", 0) if dev_type == "cuda" else torch.device("cpu")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            load()
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(root, "store"),
                                                             world),
                                rank=rank, world_size=world)
        try:
            mesh = M.make_mesh(device=dev.type, backend="gloo")
            with open(os.path.join(root, "inputs.pkl"), "rb") as f:
                inp = _to(pickle.load(f), dev)
            backend.reset_launch_counts()
            got = parallel_drive(inp, mesh)
            launches = backend.kernel_report()
            # timed again, warm: the first run in a new process starts its
            # kernels and libraries cold
            got = got[0], parallel_drive(inp, mesh)[1], got[2]
        finally:
            dist.destroy_process_group()
        with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump((got, launches), f)
    except BaseException:
        with open(os.path.join(root, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _flat(tree, prefix=""):
    """{path: tensor} of a result tree."""
    import dataclasses
    import torch
    if dataclasses.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    if isinstance(tree, (tuple, list)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}.{k}" if prefix else str(k)))
        return out
    return {prefix: tree} if isinstance(tree, torch.Tensor) else {}


def _differences(a, b) -> list:
    """The leaves of two result trees that are not bit-identical, with the
    largest difference of each."""
    import torch
    fa, fb = _flat(a), _flat(b)
    diff = []
    for k in fa:
        x, y = fa[k], fb[k]
        if x.shape != y.shape or not torch.equal(x, y):
            d = ((x.double() - y.double()).abs().max().item()
                 if x.shape == y.shape and x.numel() else float("nan"))
            diff.append((k, d))
    return diff


def spawn_ranks(world: int, inp, card: str):
    """Phase 11 (b)'s ranks as processes on the card; every one is joined
    (or ended at PAR_TIMEOUT_S).  Returns each rank's (results, launches)."""
    import multiprocessing
    import pickle
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        with open(os.path.join(root, "inputs.pkl"), "wb") as f:
            pickle.dump(_to(inp, "cpu"), f)
        ctx = multiprocessing.get_context("spawn")
        dev_type = inp["frames"][0].device.type
        procs = [ctx.Process(target=parallel_rank, args=(r, world, root, dev_type))
                 for r in range(world)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = t0 + PAR_TIMEOUT_S
        for p in procs:
            p.join(max(deadline - time.perf_counter(), 1.0))
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(30)
        print(f"parallel (b): {world} ranks on {card} under gloo ran in "
              f"{time.perf_counter() - t0:.2f} s (process start included)")
        outs = []
        for r, p in enumerate(procs):
            path = os.path.join(root, f"rank{r}.pkl")
            if p.exitcode != 0 or not os.path.exists(path):
                err = os.path.join(root, f"rank{r}.err")
                msg = "no traceback"
                if os.path.exists(err):
                    with open(err) as f:
                        msg = f.read()
                raise AssertionError(f"parallel (b): rank {r} exited with {p.exitcode}:\n{msg}")
            with open(path, "rb") as f:
                outs.append(pickle.load(f))
        return outs
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _close(x, y, rtol, atol) -> bool:
    import torch
    return x.shape == y.shape and bool(torch.allclose(x.double(), y.double(), rtol=rtol,
                                                      atol=atol))


def hold_parallel_world(ref, got, schur_ranks, ref_schur, world: int):
    """Phase 11 (b)'s gates: the frame features and every integer exact,
    the tracker's and the epipolar search's floats within their
    tolerances, the Schur systems bit-identical on every rank and the
    first LM step's within PAR_SCHUR_TOL of the unsharded one, the LM runs'
    final costs within PAR_COST_TOL.  Prints what differs and by how much."""
    import torch

    tag, failed = f"parallel (b) world {world}", []
    diff = _differences(got["frame_features"], ref["frame_features"])
    if diff:
        failed.append(f"{tag}: frame features differ: {diff[:8]}")
    for i, ((p_g, r_g), (p_r, r_r)) in enumerate(zip(got["track_frame"], ref["track_frame"])):
        fg, fr = _flat(r_g), _flat(r_r)
        for k in fr:
            if fr[k].is_floating_point():
                tol = (0.0, 1e-3) if k == "sel_pos_l0" else PAR_POSE_TOL
                if not _close(fg[k], fr[k], *tol):
                    failed.append(f"{tag}: frame {i} {k} beyond {tol}")
            elif not torch.equal(fg[k], fr[k]):
                failed.append(f"{tag}: frame {i} {k} differs")
        if not _close(p_g.t, p_r.t, *PAR_POSE_TOL):
            failed.append(f"{tag}: frame {i} pose differs")
    n_exact = sum(not _differences(g, r) for g, r in zip(got["track_frame"], ref["track_frame"]))
    ok_g, pos_g, uv_g, lvl_g = got["epipolar_match"]
    ok_r, pos_r, uv_r, lvl_r = ref["epipolar_match"]
    if not (torch.equal(ok_g, ok_r) and torch.equal(lvl_g[ok_r], lvl_r[ok_r])):
        failed.append(f"{tag}: epipolar ok/levels differ")
    d_pos = (pos_g[ok_r] - pos_r[ok_r]).abs().max().item() if ok_r.any() else 0.0
    d_uv = (uv_g[ok_r] - uv_r[ok_r]).abs().max().item() if ok_r.any() else 0.0
    if not (_close(pos_g[ok_r], pos_r[ok_r], *PAR_EPI_POS_TOL)
            and _close(uv_g[ok_r], uv_r[ok_r], *PAR_EPI_UV_TOL)):
        failed.append(f"{tag}: epipolar positions beyond tolerance: max |d pos_w| "
                      f"{d_pos:.3g} (tol {PAR_EPI_POS_TOL}), max |d uv| {d_uv:.3g} "
                      f"(tol {PAR_EPI_UV_TOL})")
    print(f"{tag}: frame features {'exact' if not diff else 'DIFFER'}; "
          f"{len(ref['track_frame'])} tracked frames, {n_exact} bit-identical; epipolar "
          f"{int(ok_r.sum())} matched of {ok_r.shape[0]}, max |d pos_w| {d_pos:.3g}, "
          f"max |d uv| {d_uv:.3g}")
    for run, kept in schur_ranks[0].items():
        for r, other in enumerate(schur_ranks[1:], 1):
            if [h for h, _, _ in other[run]] != [h for h, _, _ in kept]:
                failed.append(f"{tag}: rank {r}'s Schur matrices differ from rank 0's "
                              f"in run {run}")
        print(f"{tag}: {run}: the {len(kept)} Schur matrices solved are bit-identical on "
              f"all {world} ranks (sha256 {kept[0][0][:16]}...)")
    for key in ("prob", "cap"):
        (_, A_g, b_g), (_, A_r, b_r) = (schur_ranks[0][f"{key}first"][0],
                                        ref_schur[f"{key}first"][0])
        rel_a = ((A_g - A_r).abs().max() / A_r.abs().max()).item()
        rel_b = ((b_g - b_r).abs().max() / b_r.abs().max()).item()
        s_g, s_r = got[f"lm_{key}first"], ref[f"lm_{key}first"]
        if not (rel_a <= PAR_SCHUR_TOL and rel_b <= PAR_SCHUR_TOL
                and torch.equal(s_g.sigma_sq, s_r.sigma_sq)):
            failed.append(f"{tag}: {key}'s first LM step: Schur matrix {rel_a:.3g}, "
                          f"rhs {rel_b:.3g} (tol {PAR_SCHUR_TOL}), sigma "
                          f"{float(s_g.sigma_sq)} vs {float(s_r.sigma_sq)}")
        d_t1 = (s_g.pose_a.t - s_r.pose_a.t).abs().max().item()
        d_r1 = (s_g.pose_a.R - s_r.pose_a.R).abs().max().item()
        d_p1 = (s_g.points - s_r.points).abs().max().item()
        print(f"{tag}: lm {key}'s first step: accepted {int(s_g.accepted)} vs "
              f"{int(s_r.accepted)}, cost {float(s_g.cost):.7g} vs {float(s_r.cost):.7g}, "
              f"max |d pose t| {d_t1:.3g}, max |d pose R| {d_r1:.3g} (tol {PAR_POSE_TOL}), "
              f"max |d point| {d_p1:.3g} (tol {PAR_POINT_TOL})")
        if not (int(s_g.accepted) == int(s_r.accepted)
                and _close(s_g.pose_a.t, s_r.pose_a.t, *PAR_POSE_TOL)
                and _close(s_g.pose_a.R, s_r.pose_a.R, *PAR_POSE_TOL)
                and _close(s_g.points, s_r.points, *PAR_POINT_TOL)):
            failed.append(f"{tag}: {key}'s first LM step's state beyond tolerance")
        g, r = got[f"lm_{key}"], ref[f"lm_{key}"]
        rel = abs(float(g.cost) - float(r.cost)) / float(r.cost)
        print(f"{tag}: lm {key} (n = {A_r.shape[0]}): first step's Schur matrix within "
              f"{rel_a:.3g} and rhs {rel_b:.3g} of the unsharded (tol {PAR_SCHUR_TOL}), sigma^2 "
              f"exact; after {PAR_LM_STEPS} steps cost {float(g.cost):.7g} vs {float(r.cost):.7g} "
              f"(rel {rel:.3g}, tol {PAR_COST_TOL}), accepted {int(g.accepted)} vs "
              f"{int(r.accepted)}, iterations {int(g.iterations)} vs {int(r.iterations)}, "
              f"max |d pose t| {(g.pose_a.t - r.pose_a.t).abs().max().item():.3g}, "
              f"max |d point| {(g.points - r.points).abs().max().item():.3g}")
        if not rel <= PAR_COST_TOL:
            failed.append(f"{tag}: lm {key} final cost rel {rel} > {PAR_COST_TOL}")
    try:
        hold_scatter(got["lm_scatter"], ref["lm_scatter"], tag)
    except AssertionError as e:
        failed.append(str(e))
    if failed:
        raise AssertionError("; ".join(failed))


def hold_epipolar_parts(inp, got, ref, world: int):
    """The cause of the epipolar search's differences at ``world`` ranks:
    the unsharded search called here on each rank's part of the Q
    candidates, in turn, gives the world's result bit for bit, and so
    differs from the search over all Q as much as the world does."""
    import torch
    from mcptam_tpu_torch.map.epipolar import epipolar_match

    Q = inp["epi"][0].shape[0]
    parts = [epipolar_match(inp["ms"], inp["cams"], *(a[i * Q // world:(i + 1) * Q // world]
                                                      for a in inp["epi"]), **inp["epi_kw"])
             for i in range(world)]
    cat = _to(tuple(torch.cat(x) for x in zip(*parts)), "cpu")
    ok = ref[0]
    d_pos = (cat[1][ok] - ref[1][ok]).abs().max().item() if ok.any() else 0.0
    diff = _differences(cat, got)
    print(f"parallel (b) world {world}: the unsharded epipolar search on each of the "
          f"{world} parts of Q = {Q} in one process: max |d pos_w| {d_pos:.3g} against the "
          f"search over all Q; {'bit-identical' if not diff else f'differs {diff[:4]}'} "
          f"to the world's result")
    if diff:
        raise AssertionError(f"parallel (b): the epipolar search by parts differs from "
                             f"world {world}'s: {diff[:4]}")


def hold_scatter(g, r, tag: str):
    """The LM run without a table against the unsharded one: cost within
    PAR_COST_TOL, poses within PAR_POSE_TOL, the same accepted steps."""
    rel = abs(float(g.cost) - float(r.cost)) / float(r.cost)
    print(f"{tag}: lm without a table, {PAR_SCATTER_STEPS} steps: cost {float(g.cost):.7g} vs "
          f"{float(r.cost):.7g} (rel {rel:.3g}, tol {PAR_COST_TOL}), accepted "
          f"{int(g.accepted)} vs {int(r.accepted)}, max |d pose t| "
          f"{(g.pose_a.t - r.pose_a.t).abs().max().item():.3g}, max |d point| "
          f"{(g.points - r.points).abs().max().item():.3g}")
    if not (rel <= PAR_COST_TOL and _close(g.pose_a.t, r.pose_a.t, *PAR_POSE_TOL)
            and int(g.accepted) == int(r.accepted)):
        raise AssertionError(f"{tag}: lm without a table beyond tolerance")


def phase_parallel(cams, cfb, cams_sbi, frames, card, dev):
    """Phase 11.  Returns the launch counts of (a)'s sharded drive."""
    import torch
    from mcptam_tpu_torch import backend
    from mcptam_tpu_torch.parallel import mesh as M

    t0 = time.perf_counter()
    inp = parallel_inputs(cams, cfb, cams_sbi, frames, dev)
    Q, n_want = inp["epi"][-1].shape[0], int(inp["epi"][-1].sum())
    print(f"parallel: inputs in {time.perf_counter() - t0:.2f} s: LM 16 poses / 2048 points / "
          f"{inp['prob'].m_valid.shape[0]} measurements (n = 96) and at {CAPACITY_MKFS} MKFs "
          f"(n = {6 * CAPACITY_MKFS}); the map after integrating the MKF at excursion pose "
          f"{PAR_MKF_POSE}; its epipolar call Q = {Q} ({n_want} wanted); "
          f"{PAR_TRACK_FRAMES} trajectory frames of ({C},{H},{W})")
    ref, ref_secs, ref_schur = parallel_drive(inp)
    from mcptam_tpu_torch.ba.bundle import create_lm_state, lm_run

    # (a) world 1 on NCCL, in this process: bit-identical to the unsharded
    # port; then both timed again, in turns
    mesh = M.make_mesh(device=dev.type)
    try:
        torch.distributed.all_reduce(torch.zeros(1, device=mesh.device))  # NCCL set up
        backend.reset_launch_counts()
        got, secs, schur = parallel_drive(inp, mesh)
        torch.cuda.synchronize()
        launches = backend.kernel_report()
        backend_name = torch.distributed.get_backend()
        ref_secs2 = parallel_drive(inp)[1]
        secs2 = parallel_drive(inp, mesh)[1]
    finally:
        mesh.close()
    for name in ref_secs:
        diff = _differences(got[name], ref[name])
        print(f"parallel (a) world 1 on {backend_name}: {name} {secs[name] * 1e3:.3f} / "
              f"{secs2[name] * 1e3:.3f} ms sharded, {ref_secs[name] * 1e3:.3f} / "
              f"{ref_secs2[name] * 1e3:.3f} ms unsharded (in turns: unsharded, sharded, "
              f"unsharded, sharded), {'bit-identical' if not diff else f'differs {diff[:4]}'} "
              f"on {card}")
        if diff and name != "lm_scatter":
            raise AssertionError(f"parallel (a): {name} at world 1 differs from the "
                                 f"unsharded port: {diff[:8]}")
    # the path without a table: two unsharded runs, and world 1, held alike
    again = _to(lm_run(inp["prob_nt"], create_lm_state(inp["prob_nt"]), inp["lm_cams"],
                       PAR_SCATTER_STEPS), "cpu")
    print(f"parallel (a): lm_scatter, a second unsharded run against the first: "
          f"{_differences(again, ref['lm_scatter'])[:4] or 'bit-identical'}")
    hold_scatter(got["lm_scatter"], ref["lm_scatter"], "parallel (a) world 1")
    if [[h for h, _, _ in v] for v in schur.values()] != \
            [[h for h, _, _ in v] for v in ref_schur.values()]:
        raise AssertionError("parallel (a): a Schur matrix at world 1 differs from the "
                             "unsharded port's")
    for k in ("fast_frontend", "search_patches", "gather_windows", "esm_align_all",
              "spd_solve_blocked", "spd_solve_blocked_global", "half_sample"):
        if launches[k] <= 0:
            raise AssertionError(f"parallel (a): kernel {k} never launched")
    print(f"parallel (a): launches {launches}")

    # (b) PAR_WORLD processes on the one card under gloo
    torch.cuda.synchronize()
    ranks = spawn_ranks(PAR_WORLD, inp, card)
    (got2, w2_secs, _), _ = ranks[0]
    for r, ((g, _, _), lr) in enumerate(ranks):
        diff = _differences(g, got2)
        if diff:
            raise AssertionError(f"parallel (b): rank {r}'s results differ from rank 0's: "
                                 f"{diff[:8]}")
    for name in ref_secs:
        print(f"parallel (b) world {PAR_WORLD} on gloo: {name} {w2_secs[name] * 1e3:.3f} ms "
              f"sharded (rank 0, its second run), {ref_secs2[name] * 1e3:.3f} ms unsharded "
              f"on {card}")
    print(f"parallel (b): rank 0's launches {ranks[0][1]}")
    hold_epipolar_parts(inp, got2["epipolar_match"], ref["epipolar_match"], PAR_WORLD)
    hold_parallel_world(ref, got2, [r[0][2] for r in ranks], ref_schur, PAR_WORLD)
    return launches


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
    from mcptam_tpu_torch.map.state import clone_tree
    from mcptam_tpu_torch.ops import batch_patch
    from mcptam_tpu_torch.ops.search_kernel import search_patches_reference
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
        if any(k in line for k in ("registers", "Compiling entry", "spill")):
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
    sizes = {}
    results = {"fast_frontend": check_fast(frames[0].to(torch.float32))}
    results["gather_windows"], sizes["gather_windows"] = check_gather(feats0, ms.mkfs.atlas, gen)
    results["esm_align_all"], sizes["esm_align_all"] = check_esm(
        make_frame_features(frames[0]), feats1)
    results["half_sample"] = check_half_sample(frames[0].to(torch.float32))
    results["gather_unaligned"] = check_gather_unaligned(feats1, gen)
    lm_prob, lm_cams = lm_problem(dev)
    spd_results, spd_sizes = check_spd(*schur_system(lm_prob, lm_cams), gen)
    results.update(spd_results)
    sizes.update(spd_sizes)
    results["spd_solve_blocked_global"], sizes["spd_solve_blocked_global"] = check_spd_global(
        *schur_system(pad_poses(lm_prob, CAPACITY_MKFS), lm_cams), gen)
    # the fused search on the coarse and fine calls of a tracked batch, on
    # a System of its own over a copy of the map
    rec = System(cams, cfb, cams_sbi, H, W, tcfg=TrackerConfig(), max_points=MAX_POINTS,
                 max_mkfs=MAX_MKFS, max_meas=MAX_MEAS, pipeline_depth=2 * B)
    rec.ms, rec.initialized = clone_tree(ms), True
    rec.vars["AddingMKFs"] = False
    results["search_patches"], sizes["search_patches"] = check_search(
        record_searches(rec, torch.stack(frames[:B])))
    results["stability_filter"], sizes["stability_filter"] = check_stability(cams, cfb, frames)
    check_sbi_resize(dev)
    for k, (err, ms_k, ms_p, (b_ms, b_by), lib_ms) in results.items():
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"kernel {k}: max_abs_err {err} kernel {ms_k:.4f} ms plain {ms_p:.4f} ms "
              f"library {lib} bound {b_ms:.6f} ms ({b_by}) ({card})")

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
    launches_track = launches = backend.kernel_report()

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
    if mean_found < MIN_FOUND or max_err >= MAX_POSE_ERR:
        raise AssertionError(f"quality gates failed: mean_found {mean_found} "
                             f"(>= {MIN_FOUND}), max_pose_err {max_err} (< {MAX_POSE_ERR})")
    for k in ("fast_frontend", "search_patches", "esm_align_all", "half_sample"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the tracking path")
    if launches["search_patches"] != 2 * N_POSES:   # the coarse and fine search
        raise AssertionError(f"tracking: search_patches launched {launches['search_patches']} "
                             f"times for {N_POSES} frames")
    if launches["fast_frontend"] != N_POSES:       # K1 once a frame
        raise AssertionError(f"tracking: fast_frontend launched {launches['fast_frontend']} "
                             f"times for {N_POSES} frames")

    # second pass over the closed trajectory, timed after the warm first
    t0 = time.perf_counter()
    infos2 = []
    for b in batches:
        infos2 += sys_.process_frames(b)
    infos2 += sys_.flush_pipeline()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    max_err2 = float(np.max(pose_errors(infos2, poses)))
    if max_err2 >= MAX_POSE_ERR:
        raise AssertionError(f"second pass max_pose_err {max_err2}")
    print(f"slice timed pass: {N_POSES / dt:.2f} frames/s "
          f"({dt * 1e3 / N_POSES:.3f} ms/frame, B={B}, max_pose_err "
          f"{max_err2:.6f}) on {card}")
    # device operations of a tracked frame: the fused search, then the
    # plain search (the window gather and the eager operators) in its place
    ops_fused = device_ops_per_frame(sys_, batches[0])
    fused = batch_patch.find_patches
    batch_patch.find_patches = search_patches_reference
    try:
        ops_plain = device_ops_per_frame(sys_, batches[0])
    finally:
        batch_patch.find_patches = fused
    print(f"tracking: {ops_plain:.1f} device ops a frame with the plain search, "
          f"{ops_fused:.1f} with the fused search kernel (torch.profiler, B={B}) on {card}")

    # ---- 5. LM on the benchmark's global problem; K5's path; K4's global
    # path at a 64-MKF capacity
    launches_lm = phase_lm(dev, card)

    # ---- 6. mapping: process_frames with the map-maker ticking
    launches_map = phase_mapping(cams, cfb, cams_sbi, frames, poses, card)

    # ---- 7. live: process_frame from an empty map
    launches_live = phase_live(cams, cfb, cams_sbi, frames, poses, card)

    # ---- 8. the mcptam app on a dataset directory, through the native queue
    launches_app = phase_app(cams, cfb, card)

    # ---- 9. client/server: in one process over loopback TCP, then the apps
    launches_cs = phase_client_server(cams, cfb, cams_sbi, card)

    # ---- 10. calibration: both calibrator apps, then the zero-overlap
    # pose-calibration session
    launches_calib, calib_rows = phase_calibration(card, dev)
    for k, rows in calib_rows.items():
        sizes.setdefault(k, []).extend(rows)

    # ---- 11. parallel/mesh.py: world 1 on NCCL in this process, then
    # PAR_WORLD ranks on the one card under gloo
    launches_par = phase_parallel(cams, cfb, cams_sbi, frames, card, dev)
    launches = dict(launches_live)
    # BA's kernels are read from their own paths: K4 from mapping, K5 and
    # K4's global path from LM
    launches["spd_solve_blocked"] = launches_map["spd_solve_blocked"]
    launches.update(launches_lm)
    by_phase = {"tracking": launches_track, "lm": launches_lm,
                "mapping": launches_map, "live": launches_live, "app": launches_app,
                "client_server": launches_cs, "calibration": launches_calib,
                "parallel": launches_par}

    kernels = [
        {"name": k, "route": "cuda", "source": KERNELS[k][0],
         "replaces": KERNELS[k][1], "launches": launches[k],
         "max_abs_err": results[k][0], "ms": results[k][1],
         "plain_ms": results[k][2], "bound_ms": results[k][3][0],
         "bound_by": results[k][3][1], "library_ms": results[k][4],
         "launches_by_phase": {p: c[k] for p, c in by_phase.items()
                               if c.get(k) or p == "calibration"},
         **({"sizes": sizes[k]} if k in sizes else {})}
        for k in KERNELS
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
