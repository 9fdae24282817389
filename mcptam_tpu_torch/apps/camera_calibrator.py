"""Intrinsic (Taylor model) calibration, the `camera_calibrator` binary
(port of mcptam_tpu/apps/camera_calibrator.py; ref
src/MainCameraCalibrator.cc, src/CameraCalibrator.cc).

    python -m mcptam_tpu_torch.apps.camera_calibrator --images views.npy \\
        --squares 8x6 --square-size 0.04 --out camera.json [--device cpu]

`--images` is (T,H,W) uint8 checkerboard views from the camera.  Prints
per-view detection results and the final RMS; the reference's acceptance
guidance applies: RMS should be below 0.5 px, typically below 0.3
(src/CameraCalibrator.cc:228).  Detection and the nonlinear refinement
run on the GPU unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse

import numpy as np

from mcptam_tpu_torch.apps._common import add_device_arg, resolve_device


def grids_from_images(images: np.ndarray, squares, square_size: float,
                      device="cuda"):
    """Detect and label the board in every view.  The (r,c) -> board
    mapping uses min-normalised detection coordinates: for a planar board
    every dihedral relabelling is realisable by a proper rotation of the
    board pose, so per-view consistency is all intrinsics need."""
    from mcptam_tpu_torch.calib.corners import detect_checkerboard

    grids_uv, grids_board, report = [], [], []
    for i, img in enumerate(images):
        grid, _, _ = detect_checkerboard(img, device=device)
        if grid is None or len(grid) < 20:
            report.append((i, 0))
            continue
        uv = np.array(list(grid.values()))
        rc = np.array(list(grid.keys()), np.float64)
        grids_uv.append(uv)
        grids_board.append(rc[:, ::-1] * square_size)   # x = col, y = row
        report.append((i, len(grid)))
    return grids_uv, grids_board, report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_device_arg(p)
    p.add_argument("--images", required=True, help="(T,H,W) uint8 .npy/.npz")
    p.add_argument("--squares", default="8x6")
    p.add_argument("--square-size", type=float, default=0.04)
    p.add_argument("--out", default="", help="output camera JSON")
    p.add_argument("--name", default="camera1")
    p.add_argument("--drop-worst", type=int, default=0,
                   help="review loop: after a first optimisation, discard "
                        "the N views with the worst reprojection RMS and "
                        "re-optimise (the reference operator's grabbed-"
                        "frame review/discard, CameraCalibrator::Run)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    from mcptam_tpu_torch.calib.intrinsic import calibrate_camera_reviewed
    from mcptam_tpu_torch.io.rig_config import save_rig

    images = np.load(args.images)
    if hasattr(images, "files"):
        images = images[images.files[0]]
    T, H, W = images.shape
    sx, sy = (int(v) for v in args.squares.split("x"))

    grids_uv, grids_board, report = grids_from_images(
        images, (sx, sy), args.square_size, device=device)
    for i, n in report:
        print(f"view {i:3d}: {'%3d corners' % n if n else 'no grid found'}")
    if len(grids_uv) < 3:
        print("not enough usable views (need >= 3)")
        return 1

    params9, rms, pv, kept = calibrate_camera_reviewed(
        grids_uv, grids_board, (W, H), drop_worst=args.drop_worst, device=device)
    for i, e in enumerate(pv):
        tag = "dropped" if i not in kept else f"{e:6.3f} px"
        print(f"view rms {i:3d}: {tag}")
    print(f"calibrated from {len(kept)} views; RMS = {rms:.3f} px "
          f"({'OK' if rms < 0.5 else 'POOR — re-capture views'})")
    print("params9 =", np.array2string(np.asarray(params9), precision=6))
    if args.out:
        save_rig(args.out, [params9], (W, H), names=[args.name])
        print(f"saved to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
