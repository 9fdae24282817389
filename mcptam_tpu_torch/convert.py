"""Carry state across from the JAX package, and back.

The ``*_from_numpy`` functions take the JAX package's pytrees with numpy
leaves — what ``jax.device_get`` returns for an ``SE3``, ``CameraModel``,
``MapState``, ``TrackerState``, ``FrameFeatures``, ``BundleProblem`` or
``LMState``, or nested dicts and tuples of ``np.ndarray`` with the same
field names — and build the port's dataclasses on a device.  A field that
is None (an unset optional of a bundle problem) stays None.  ``to_numpy``
goes back to nested dicts of numpy arrays for comparison.  The map,
cameras and tracker state are this system's "weights": converted, both
packages compute the same thing.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from mcptam_tpu_torch.ba.bundle import BundleProblem, LMState
from mcptam_tpu_torch.core.camera import CameraModel
from mcptam_tpu_torch.core.se3 import SE3
from mcptam_tpu_torch.map.keyframe import FrameFeatures
from mcptam_tpu_torch.map.state import MapState
from mcptam_tpu_torch.tracker.tracker import TrackerState


def _get(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def _tensor(a, device):
    return torch.as_tensor(np.array(a, copy=True), device=device)


def _from(cls, src, device):
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        val = _get(src, f.name)
        kind = hints[f.name]
        if val is None:
            kw[f.name] = None
        elif dataclasses.is_dataclass(kind):
            kw[f.name] = _from(kind, val, device)
        elif isinstance(val, (tuple, list)):
            kw[f.name] = tuple(_tensor(v, device) for v in val)
        else:
            kw[f.name] = _tensor(val, device)
    return cls(**kw)


def se3_from_numpy(src, device="cuda") -> SE3:
    return _from(SE3, src, device)


def camera_from_numpy(src, device="cuda") -> CameraModel:
    return _from(CameraModel, src, device)


def map_state_from_numpy(src, device="cuda") -> MapState:
    return _from(MapState, src, device)


def tracker_state_from_numpy(src, device="cuda") -> TrackerState:
    return _from(TrackerState, src, device)


def frame_features_from_numpy(src, device="cuda") -> FrameFeatures:
    return _from(FrameFeatures, src, device)


def bundle_problem_from_numpy(src, device="cuda") -> BundleProblem:
    return _from(BundleProblem, src, device)


def lm_state_from_numpy(src, device="cuda") -> LMState:
    return _from(LMState, src, device)


def to_numpy(obj):
    """Port dataclass / tensor / tuple -> nested dicts of numpy arrays."""
    if dataclasses.is_dataclass(obj):
        return {f.name: to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (tuple, list)):
        return tuple(to_numpy(v) for v in obj)
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return obj

