"""Rig extrinsic calibration, the `pose_calibrator` binary (port of
mcptam_tpu/apps/pose_calibrator.py; ref src/MainPoseCalibrator.cc,
src/PoseCalibrator.cc).

    python -m mcptam_tpu_torch.apps.pose_calibrator --rig rig.json \\
        --video views.npz --squares 8x6 --square-size 0.04 \\
        --out rig_cal.json [--tracking] [--device cpu]

`--video` is (C,T,H,W) uint8: synchronised views of a checkerboard from
every camera.  The default pipeline is detection -> canonical labelling ->
per-view PnP -> relative-pose consensus (resolves the 180-degree twin of
symmetric boards) -> rotation averaging -> the joint Calib-layout bundle
(calib/extrinsic.py; ref src/MapMakerCalib.cc:248-528).  `--tracking`, and
the fallback when the cameras share too few board views, calibrates by
tracking a shared board-anchored map instead (calib/pose_calib.py).  Runs
on the GPU unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mcptam_tpu_torch.apps._common import add_device_arg, resolve_device


def detect_all(frames: np.ndarray, n_rows: int, n_cols: int, device="cuda"):
    """-> dict[(frame, cam)] -> list of candidate labellings."""
    from mcptam_tpu_torch.calib.corners import canonical_labelings, detect_checkerboard

    C, T = frames.shape[:2]
    cands = {}
    for c in range(C):
        for t in range(T):
            grid, _, _ = detect_checkerboard(frames[c, t], device=device)
            if grid is None or len(grid) < (n_rows * n_cols) // 2:
                continue
            labs = canonical_labelings(frames[c, t], grid, n_rows, n_cols)
            if labs:
                cands[(t, c)] = labs
    return cands


def resolve_orientation(cands, params9_per_cam, board2_grid, image_size):
    """PnP every candidate labelling; for symmetric boards pick, per view,
    the labelling whose cam-from-cam0 relative rotation agrees with the
    cross-frame consensus (the board pose varies per frame, the rig
    extrinsic does not: only the correct twin is stable).  Host numpy."""
    from mcptam_tpu_torch.calib.extrinsic import board_pose_pnp
    from mcptam_tpu_torch.core.se3 import so3_ln

    n_rows, n_cols = board2_grid.shape[:2]
    pnp = {}  # (f,c) -> list[((R,t), lab, bidx, uv)]
    for (f, c), labs in cands.items():
        outs = []
        for lab in labs:
            rc = np.array(list(lab.keys()))
            uv = np.array(list(lab.values()))
            bidx = rc[:, 0] * n_cols + rc[:, 1]
            out = board_pose_pnp(params9_per_cam[c], board2_grid.reshape(-1, 2)[bidx],
                                 uv, image_size)
            if out is not None:
                outs.append((out, lab, bidx, uv))
        if outs:
            pnp[(f, c)] = outs

    def angle(R):
        return float(torch.linalg.vector_norm(
            so3_ln(torch.as_tensor(R, dtype=torch.float32))))

    # consensus per camera c > 0: for each frame, the candidate whose
    # relative rotation is closest to the other frames' current choices
    chosen = {}
    frames_all = sorted({f for (f, c) in pnp})
    for (f, c), outs in pnp.items():
        if len(outs) == 1 or c == 0:
            chosen[(f, c)] = outs[0]
    for _ in range(3):
        for (f, c), outs in pnp.items():
            if (f, c) in chosen and len(outs) == 1:
                continue
            if c == 0 or (f, 0) not in chosen:
                if (f, c) not in chosen:
                    chosen[(f, c)] = outs[0]
                continue
            R0 = chosen[(f, 0)][0][0]
            rels = []
            for f2 in frames_all:
                if f2 == f or (f2, c) not in chosen or (f2, 0) not in chosen:
                    continue
                rels.append(chosen[(f2, c)][0][0] @ chosen[(f2, 0)][0][0].T)
            if not rels:
                chosen[(f, c)] = outs[0]
                continue
            R_ref = rels[len(rels) // 2]
            chosen[(f, c)] = min(outs, key=lambda o: angle((o[0][0] @ R0.T) @ R_ref.T))
    return chosen


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_device_arg(p)
    p.add_argument("--rig", required=True, help="rig JSON with intrinsics")
    p.add_argument("--video", required=True, help="(C,T,H,W) uint8")
    p.add_argument("--squares", default="8x6")
    p.add_argument("--square-size", type=float, default=0.04)
    p.add_argument("--out", default="", help="output rig JSON with extrinsics")
    p.add_argument(
        "--tracking", action="store_true",
        help="calibrate by tracking the shared board-anchored map "
             "(TrackerCalib/MapMakerCalib flow: required for rigs with "
             "no simultaneous board views; also the automatic fallback "
             "when shared views are insufficient)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    from mcptam_tpu_torch.calib.board import inner_corner_points
    from mcptam_tpu_torch.calib.extrinsic import calibrate_rig
    from mcptam_tpu_torch.io.rig_config import load_rig, load_video, save_rig

    cams, _, H, W, _, names = load_rig(args.rig, device=device)
    frames = load_video(args.video)
    C = frames.shape[0]
    sx, sy = (int(v) for v in args.squares.split("x"))
    board3 = inner_corner_points((sx, sy), args.square_size)
    n_rows, n_cols = board3.shape[:2]
    board2_grid = board3[..., :2]
    with open(args.rig) as f:
        params9_per_cam = [np.asarray(c["params"]) for c in json.load(f)["cameras"]]

    cands = detect_all(frames, n_rows, n_cols, device=device)
    print(f"detections: {len(cands)} (frame,cam) views "
          f"across {C} cameras, {frames.shape[1]} frames")
    chosen = resolve_orientation(cands, params9_per_cam, board2_grid, (W, H))
    observations = {(f, c): {"uv": uv, "board_idx": bidx}
                    for (f, c), (_out, _lab, bidx, uv) in chosen.items()}

    def lab_to_uv_bidx(lab):
        rc = np.array(list(lab.keys()))
        return np.array(list(lab.values())), rc[:, 0] * n_cols + rc[:, 1]

    # tracking mode gets EVERY candidate labelling: cross-view consensus
    # cannot resolve a symmetric board's twin when the cameras never see
    # the board together; the session arbitrates by tracking the map
    multi_observations = {key: [lab_to_uv_bidx(lab) for lab in labs]
                          for key, labs in cands.items()}

    def tracking_calibration():
        """TrackerCalib/MapMakerCalib flow: every camera bootstraps from
        the board when it sees it and tracks the shared board-anchored
        map; the extrinsics come from simultaneous map tracking
        (src/PoseCalibrator.cc:221-411)."""
        from mcptam_tpu_torch.calib.pose_calib import PoseCalibSession
        from mcptam_tpu_torch.config import MapMakerConfig, TrackerConfig
        from mcptam_tpu_torch.io.synthetic import make_sbi_cams

        session = PoseCalibSession(
            cams=cams, cams_sbi=make_sbi_cams(cams, H, W), params9=params9_per_cam,
            board_pts2=board2_grid.reshape(-1, 2), H=H, W=W,
            tcfg=TrackerConfig(max_ssd_per_pixel=500.0), mcfg=MapMakerConfig())
        for t in range(frames.shape[1]):
            session.process_frame(frames[:, t], {
                c: labs for (f, c), labs in multi_observations.items() if f == t})
        session.calib_init()
        session.calib_step(40)
        return session.cam_from_base

    if args.tracking:
        cam_from_base = tracking_calibration()
    else:
        try:
            cam_from_base, _, _ = calibrate_rig(
                params9_per_cam, observations, board2_grid.reshape(-1, 2), (W, H), cams)
        except ValueError as e:
            print(f"shared-board path failed ({e}); "
                  "falling back to tracking calibration")
            cam_from_base = tracking_calibration()
    for c in range(C):
        v6 = cam_from_base[c].ln().cpu().numpy()
        print(f"cam {c} ({names[c]}): cam_from_base ln = "
              + np.array2string(v6, precision=5))
    if args.out:
        save_rig(args.out, params9_per_cam, (W, H), cam_from_base=cam_from_base,
                 names=names)
        print(f"saved to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
