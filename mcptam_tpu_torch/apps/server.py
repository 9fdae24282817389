"""Off-board map server (the `mcptam_server` binary, src/MainServer.cc).

    python -m mcptam_tpu_torch.apps.server --rig rig.json [--port 0] \
        [--max-points N --max-mkfs M --max-meas K] [--device cuda|cpu]

Prints `PORT <n>` once listening (port 0: the kernel picks one).  SIGINT
or SIGTERM stops the loop; the server then exits with 0.  The capacities
must be the client's.
"""

from __future__ import annotations

import argparse
import signal
import threading

from mcptam_tpu_torch.apps._common import add_device_arg, resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    add_device_arg(p)
    p.add_argument("--rig", required=True, help="rig JSON (io/rig_config.py)")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--max-points", type=int, default=None)
    p.add_argument("--max-mkfs", type=int, default=None)
    p.add_argument("--max-meas", type=int, default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    from mcptam_tpu_torch.config import MAX_MEAS, MAX_MKFS, MAX_POINTS
    from mcptam_tpu_torch.io.rig_config import load_rig
    from mcptam_tpu_torch.map.state import create_map_state
    from mcptam_tpu_torch.system.network import Channel, MapServer

    args = parse_args(argv)
    device = resolve_device(args.device)
    cams, cam_from_base, H, W, _, _ = load_rig(args.rig, device=device)
    ms = create_map_state(H, W, int(cam_from_base.t.shape[0]), cam_from_base,
                          args.max_points or MAX_POINTS, args.max_mkfs or MAX_MKFS,
                          args.max_meas or MAX_MEAS)
    channel = Channel.serve(args.port)
    try:
        print(f"PORT {channel.port}", flush=True)
        server = MapServer(channel, cams, ms)
        stop = threading.Event()
        signal.signal(signal.SIGINT, lambda *a: stop.set())
        signal.signal(signal.SIGTERM, lambda *a: stop.set())
        server.run(stop_event=stop)
    finally:
        channel.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
