"""Standalone tracker and map-maker (the `mcptam` binary, src/Main.cc:53).

    python -m mcptam_tpu_torch.apps.mcptam --rig rig.json --video seq.npz \
        [--out-map map.npz] [--frames N] [--fps 30] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

from mcptam_tpu_torch.apps._common import (
    add_device_arg, add_rig_video_args, build_system_inputs, load_gt_poses,
    resolve_device, run_tracking_loop,
)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    add_device_arg(p)
    add_rig_video_args(p)
    p.add_argument("--out-map", default="", help="save the final map (.npz)")
    p.add_argument("--load-map", default="", help="start from a saved map")
    p.add_argument("--align-plane", action="store_true",
                   help="align the world to the dominant plane at the end")
    p.add_argument("--export-ply", default="",
                   help="write the final map as a PLY cloud")
    p.add_argument("--dump-kfs", default="",
                   help="directory for keyframe overlay images (.ppm)")
    p.add_argument("--eval-gt", default="",
                   help="ground-truth trajectory .npy ((T,3,4) or (T,6) "
                        "ln vectors); prints ATE/RPE after the run")
    p.add_argument("--batch", type=int, default=1,
                   help="frames a call (the throughput mode; control "
                        "actions lag by up to batch + pipeline frames)")
    p.add_argument("--pipeline", type=int, default=0,
                   help="frames kept in flight before their results are read")
    p.add_argument("--mm-tick-every", type=int, default=1,
                   help="run the map-maker tick every Nth batch")
    return p.parse_args(argv)


def run(args: argparse.Namespace):
    """Build the System from the rig, track the video, then evaluate, align,
    export and dump as the flags ask, printing each outcome.  Returns
    (system, infos)."""
    from mcptam_tpu_torch.system.evaluate import evaluate_run
    from mcptam_tpu_torch.system.mapio import load_map, save_map
    from mcptam_tpu_torch.system.system import System
    from mcptam_tpu_torch.system.viewer import dump_keyframes, export_ply

    device = resolve_device(args.device)
    cams, cam_from_base, cams_sbi, H, W, masks, names, frames, stamps = \
        build_system_inputs(args, device)
    system = System(cams, cam_from_base, cams_sbi, H, W, masks=masks,
                    pipeline_depth=args.pipeline)
    system.tick_every = args.mm_tick_every
    if args.load_map:
        system.ms = load_map(args.load_map, system.ms)
        system.initialized = True
    infos = run_tracking_loop(system, frames, args.fps, out_map=args.out_map or None,
                              batch=args.batch, timestamps=stamps)
    if args.eval_gt:
        gt = load_gt_poses(args.eval_gt)[: len(infos)]
        print("[mcptam] eval " + json.dumps(evaluate_run(infos, gt)))
    if args.align_plane:
        ok = system.align_to_dominant_plane()
        print(f"[mcptam] plane alignment {'done' if ok else 'failed'}")
        if args.out_map:
            save_map(args.out_map, system.ms)
    if args.export_ply:
        n = export_ply(args.export_ply, system.ms)
        print(f"[mcptam] wrote {n} vertices to {args.export_ply}")
    if args.dump_kfs:
        paths = dump_keyframes(system.ms, args.dump_kfs)
        print(f"[mcptam] wrote {len(paths)} keyframe overlays to {args.dump_kfs}")
    return system, infos


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
