"""Timing records in the reference's message taxonomy (port of
mcptam_tpu/system/timing.py; msg/TrackerTiming.msg, msg/MapMakerTiming.msg)."""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class TrackerTiming:
    """Section timers of a frame; the batched path fills only the map
    counters, as the reference's does."""
    kf_downsample: float = 0.0
    kf_feature: float = 0.0
    sbi: float = 0.0
    motion: float = 0.0
    pvs: float = 0.0
    coarse: float = 0.0
    fine: float = 0.0
    pose: float = 0.0
    depth: float = 0.0
    add: float = 0.0
    total: float = 0.0
    map_num_points: int = 0
    map_num_mkfs: int = 0


@dataclasses.dataclass
class MapMakerTiming:
    """One map-maker action (src/MapMaker.cc:197-265): host seconds it took
    and, for a finished BA, its accepted and total LM iterations."""
    elapsed: float = 0.0
    accepted_iterations: int = 0
    total_iterations: int = 0
    kind: str = "none"  # "local" | "global" | "creation" | "creation-rejected"
    map_num_points: int = 0
    map_num_mkfs: int = 0


class Stopwatch:
    """Section timer; mirrors the reference's ros::WallTime bracketing."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        t = time.perf_counter()
        dt = t - self.t0
        self.t0 = t
        return dt
