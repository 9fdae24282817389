"""The 95th percentile, over every frame returned in the window, of the
time from the process_frames call that handed the frame in to the call
that returned its FrameInfo (host clock).  Needs 20 frames or more."""

import statistics
import sys


def read(rec):
    if rec.unit != "frames" or len(rec.latencies) < 20:
        return None
    p95 = 1e3 * statistics.quantiles(rec.latencies, n=20)[18]
    print(f"frame_p95_ms: {len(rec.latencies)} frames, median "
          f"{1e3 * statistics.median(rec.latencies):.1f} ms, p95 {p95:.1f}, max "
          f"{1e3 * max(rec.latencies):.1f}", file=sys.stderr)
    return p95
