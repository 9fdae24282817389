"""The tracker's add-keyframe heuristic (port of
mcptam_tpu/map/mapmaker_core.py::need_new_mkf; the rest of the map-maker
core is not ported yet)."""

from __future__ import annotations

import torch

from mcptam_tpu_torch.config import DEFAULT_MAPMAKER, MapMakerConfig
from mcptam_tpu_torch.core.se3 import SE3
from mcptam_tpu_torch.map.state import MapState, closest_mkf_distance, count_mkfs


def need_new_mkf(ms: MapState, pose: SE3, mean_depth,
                 mcfg: MapMakerConfig = DEFAULT_MAPMAKER):
    """MapMakerClientBase::NeedNewMultiKeyFrame (src/MapMakerClientBase.cc:
    111-152): depth-scaled distance to the closest MKF in the map against
    sdMaxScaledMKFDist shrunk by the map-size factor 1 - 1/(0.5 + n_mkfs)
    (n=2 counts as 1).  The reference also measures against MKFs queued
    in its map-maker; without a map-maker that queue is empty.
    Returns (add, scaled distance)."""
    d, _ = closest_mkf_distance(ms, pose, mean_depth)
    scaled = d / torch.clamp(mean_depth, min=1e-6)
    n = count_mkfs(ms)
    n_eff = torch.where(n == 2, torch.ones_like(n), n).to(torch.float32)
    thresh = mcfg.max_scaled_mkf_dist * (1.0 - 1.0 / (0.5 + n_eff))
    return scaled > thresh, scaled
