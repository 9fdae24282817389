"""Rig configuration files: camera intrinsics, extrinsics and sizes (port
of mcptam_tpu/io/rig_config.py).  The whole rig is one JSON document:

{
  "width": 640, "height": 480,
  "cameras": [
    {"name": "camera1",
     "params": [a0, a2, a3, a4, xc, yc, c, d, e],          # Taylor 9-vector
     "cam_from_base": [ux, uy, uz, wx, wy, wz],            # SE3 ln(), optional
     "mask": "masks/camera1.npy"},                         # optional bool (H,W)
    ...
  ],
  "extrinsic_scale": 1.0                                   # optional
}
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from mcptam_tpu_torch.core.camera import make_camera, stack_cameras
from mcptam_tpu_torch.core.se3 import SE3


def load_rig(path: str, device="cuda"):
    """Returns (cams: CameraModel (C,), cam_from_base: SE3 (C,), H, W,
    masks: (C,H,W) bool ndarray or None, names: list[str]); the cameras
    and extrinsics on ``device``."""
    with open(path) as f:
        doc = json.load(f)
    H, W = int(doc["height"]), int(doc["width"])
    scale = float(doc.get("extrinsic_scale", 1.0))
    base = os.path.dirname(os.path.abspath(path))

    cam_list, v6s, masks, names = [], [], [], []
    any_mask = False
    for c in doc["cameras"]:
        names.append(c.get("name", f"camera{len(names) + 1}"))
        cam_list.append(make_camera(np.asarray(c["params"], np.float64), (W, H),
                                    device=device))
        v6 = np.asarray(c.get("cam_from_base", np.zeros(6)), np.float32)
        v6[:3] *= scale  # the extrinsic scale applies to the ln vector's translation part
        v6s.append(v6)
        if "mask" in c:
            masks.append(np.asarray(np.load(os.path.join(base, c["mask"])), bool))
            any_mask = True
        else:
            masks.append(np.ones((H, W), bool))
    cam_from_base = SE3.exp(torch.as_tensor(np.stack(v6s), device=device))
    return (stack_cameras(cam_list), cam_from_base, H, W,
            np.stack(masks) if any_mask else None, names)


def save_rig(path: str, params9_per_cam, image_size, cam_from_base: SE3 | None = None,
             names=None, masks_rel=None):
    """Write a rig JSON (SaveCalib analogue, src/PoseCalibrator.cc:602-632):
    ``image_size`` is (W, H); ``masks_rel`` names each camera's mask file
    relative to the document."""
    W, H = image_size
    ln = None if cam_from_base is None else cam_from_base.ln().detach().cpu().numpy()
    cameras = []
    for i in range(len(params9_per_cam)):
        entry = {
            "name": names[i] if names else f"camera{i + 1}",
            "params": [float(x) for x in np.asarray(params9_per_cam[i]).ravel()],
        }
        if ln is not None:
            entry["cam_from_base"] = [float(x) for x in ln[i]]
        if masks_rel and masks_rel[i]:
            entry["mask"] = masks_rel[i]
        cameras.append(entry)
    with open(path, "w") as f:
        json.dump({"width": W, "height": H, "cameras": cameras}, f, indent=1)


def load_video(path: str) -> np.ndarray:
    """A (C,T,H,W) uint8 sequence from .npy or .npz (the ``frames`` array,
    else the first)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            arr = z["frames" if "frames" in z else list(z.keys())[0]]
    else:
        arr = np.load(path)
    if arr.ndim != 4:
        raise ValueError(f"{path}: expected (C,T,H,W), got {arr.shape}")
    return np.asarray(arr, np.uint8)
