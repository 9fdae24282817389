"""On-board tracking client (the `mcptam_client` binary, src/MainClient.cc).

    python -m mcptam_tpu_torch.apps.client --rig rig.json --video seq.npz \
        --server host:port [--max-points N --max-mkfs M --max-meas K] \
        [--device cuda|cpu]

The map server (apps/server.py) must run with the same capacities.
"""

from __future__ import annotations

import argparse

from mcptam_tpu_torch.apps._common import (
    add_device_arg, add_rig_video_args, build_system_inputs, resolve_device,
    run_tracking_loop,
)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    add_device_arg(p)
    add_rig_video_args(p)
    p.add_argument("--server", required=True, help="host:port of the map server")
    p.add_argument("--max-points", type=int, default=None)
    p.add_argument("--max-mkfs", type=int, default=None)
    p.add_argument("--max-meas", type=int, default=None)
    return p.parse_args(argv)


def run(args: argparse.Namespace):
    """Track the video against the map server.  Returns (system, infos)."""
    from mcptam_tpu_torch.config import MAX_MEAS, MAX_MKFS, MAX_POINTS
    from mcptam_tpu_torch.system.client import SystemClient

    device = resolve_device(args.device)
    cams, cam_from_base, cams_sbi, H, W, masks, _, frames, stamps = \
        build_system_inputs(args, device)
    host, port = args.server.rsplit(":", 1)
    system = SystemClient(cams, cam_from_base, cams_sbi, H, W, host, int(port),
                          masks=masks, max_points=args.max_points or MAX_POINTS,
                          max_mkfs=args.max_mkfs or MAX_MKFS,
                          max_meas=args.max_meas or MAX_MEAS)
    try:
        infos = run_tracking_loop(system, frames, args.fps, timestamps=stamps)
    finally:
        system.close()
    return system, infos


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
