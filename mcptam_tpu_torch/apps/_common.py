"""Shared plumbing of the app entry points (port of
mcptam_tpu/apps/_common.py)."""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def add_device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the system runs (default: the GPU; cpu for a "
                        "check on a machine without one)")


def resolve_device(name: str) -> torch.device:
    """The torch device an app runs on.  There is no fallback: asking for
    the GPU on a machine without CUDA raises."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return torch.device(name)


def add_rig_video_args(p: argparse.ArgumentParser, video_required=True):
    p.add_argument("--rig", default="",
                   help="rig JSON (io/rig_config.py); defaults to "
                        "<dataset>/rig.json when --video is a dataset dir")
    p.add_argument("--video", required=video_required,
                   help="(C,T,H,W) uint8 .npy/.npz frame sequence, or a "
                        "dataset DIRECTORY of per-camera image sequences "
                        "(io/dataset.py layout: camera*/NNNNNN.pgm|png + "
                        "timestamps.txt + rig.json)")
    p.add_argument("--frames", type=int, default=0,
                   help="max frames to process (0 = all)")
    p.add_argument("--fps", type=float, default=30.0, help="replay rate")


def build_system_inputs(args, device):
    """Returns (cams, cam_from_base, cams_sbi, H, W, masks, names,
    frames (C,T,H,W) uint8 or None, timestamps (C,T) or None); the
    cameras on ``device``."""
    from mcptam_tpu_torch.io.dataset import load_dataset, load_sequence_dir
    from mcptam_tpu_torch.io.rig_config import load_rig, load_video
    from mcptam_tpu_torch.io.synthetic import make_sbi_cams

    stamps = None
    if args.video and os.path.isdir(args.video):
        if args.rig:
            cams, cam_from_base, H, W, masks, names = load_rig(args.rig, device=device)
            frames, stamps = load_sequence_dir(args.video, names=names, limit=args.frames)
        else:
            (cams, cam_from_base, H, W, masks, names, frames,
             stamps) = load_dataset(args.video, limit=args.frames, device=device)
    else:
        if not args.rig:
            raise SystemExit("--rig is required unless --video is a "
                             "dataset directory carrying rig.json")
        cams, cam_from_base, H, W, masks, names = load_rig(args.rig, device=device)
        frames = load_video(args.video) if args.video else None
        if frames is not None and args.frames:
            frames = frames[:, : args.frames]
    if frames is not None and frames.shape[2:] != (H, W):
        raise ValueError(f"video {frames.shape} does not match the rig's {H}x{W}")
    cams_sbi = make_sbi_cams(cams, H, W)
    return cams, cam_from_base, cams_sbi, H, W, masks, names, frames, stamps


def run_tracking_loop(system, frames, fps, out_map=None, print_every=1,
                      batch=1, timestamps=None):
    """The main loop of the tracking apps: replay the frames through the
    native synchronised queue, put each frame set on the system's device
    as float32, track it, report it.

    batch > 1 sends that many frames a call through System.process_frames
    (the throughput mode: FrameInfos drain late and carry their frame_id);
    at the end of the stream the pipeline is flushed and a partial batch's
    tail goes through process_frame.  Returns the FrameInfos in frame
    order, each frame once.  The tracer (system/timing.py) is on while the
    loop runs: ``track=`` is the host time of the frame's stage spans."""
    from mcptam_tpu_torch.io.video_source import ReplaySource
    from mcptam_tpu_torch.system import timing
    from mcptam_tpu_torch.system.mapio import save_map

    def report(info):
        if info.frame_id % print_every == 0 and not info.provisional:
            t = info.pose[:, 3]
            print(f"frame {info.frame_id:4d}  quality={info.quality} "
                  f"lost={int(info.lost)} "
                  f"found={info.n_found:4d} points={info.n_points:5d} "
                  f"mkfs={info.n_mkfs:2d} t=[{t[0]:+.3f} {t[1]:+.3f} {t[2]:+.3f}] "
                  f"track={info.timing.total * 1e3:6.1f}ms", flush=True)

    def take(new):
        for info in new:
            infos.append(info)
            report(info)

    src = ReplaySource(frames, fps=fps, timestamps=timestamps)
    src.start()
    infos, buf = [], []
    traced = timing.enable(True)
    try:
        for i in range(frames.shape[1]):
            out = src.queue.get(timeout_ms=10000)
            if out is None:
                print(f"[mcptam] frame {i}: queue timeout", file=sys.stderr)
                break
            imgs = torch.as_tensor(out[0]).to(system.device, torch.float32)
            if batch > 1:
                buf.append(imgs)
                if len(buf) == batch:
                    take(system.process_frames(torch.stack(buf)))
                    buf = []
            else:
                take([system.process_frame(imgs)])
        # end of stream: drain the pipeline, then a partial batch's tail
        take(system.flush_pipeline())
        for img in buf:
            take([system.process_frame(img)])
        take(system.flush_pipeline())
    finally:
        timing.enable(*traced)
        src.join()
        src.queue.close()
    # drop the provisional duplicates of pipeline priming; frame order
    seen = {}
    for i in infos:
        if not i.provisional or i.frame_id not in seen:
            seen[i.frame_id] = i
    infos = [seen[k] for k in sorted(seen)]
    if out_map:
        save_map(out_map, system.ms)
        print(f"[mcptam] map saved to {out_map}")
    return infos


def load_gt_poses(path: str) -> np.ndarray:
    """Ground-truth base_from_world trajectory from a .npy file of (T,3,4)
    [R|t] matrices or (T,6) se3 ln vectors -> (T,3,4) float64."""
    from mcptam_tpu_torch.core.se3 import SE3

    arr = np.load(path)
    if arr.ndim == 3 and arr.shape[1:] == (3, 4):
        return np.asarray(arr, np.float64)
    if arr.ndim == 2 and arr.shape[1] == 6:
        poses = SE3.exp(torch.as_tensor(arr, dtype=torch.float32))
        return np.concatenate([poses.R.numpy(), poses.t.numpy()[..., None]],
                              axis=-1).astype(np.float64)
    raise ValueError(f"expected (T,3,4) or (T,6) ground-truth poses, got {arr.shape}")
