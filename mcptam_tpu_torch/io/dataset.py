"""On-disk image-sequence datasets (port of mcptam_tpu/io/dataset.py; host
numpy).  A dataset is a directory of per-camera image sequences next to
the rig document:

    dataset/
      rig.json                 # io/rig_config.py document
      camera1/
        000000.pgm             # or .png / .jpg / .jpeg / .ppm
        000001.pgm ...
        timestamps.txt         # optional: one float (seconds) per frame
      camera2/ ...

Camera subdirectories follow the rig's camera names.  Images decode to
grayscale uint8: binary PGM (P5) with the built-in reader, anything else
through PIL, imported only when such a file is read.  ``timestamps.txt``
drives the synchronised queue's pairing; without it, frame index / fps.

One intended divergence from the reference: a 16-bit PGM's samples are
decoded big-endian, as the P5 format specifies; the reference reads them
in the host's byte order.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

_IMG_EXTS = (".png", ".pgm", ".ppm", ".jpg", ".jpeg")


def _read_pgm(path: str) -> np.ndarray:
    """Binary PGM (P5) reader: 8-bit samples as they are, 16-bit samples
    (big-endian) scaled to 0-255."""
    with open(path, "rb") as f:
        data = f.read()
    # header: magic, width, height, maxval, separated by whitespace and
    # optional '#' comments
    toks, pos = [], 0
    while len(toks) < 4:
        m = re.match(rb"\s*(#[^\n]*\n|\S+)", data[pos:])
        if m is None:
            raise ValueError(f"{path}: truncated PGM header")
        pos += m.end()
        tok = m.group(1)
        if not tok.startswith(b"#"):
            toks.append(tok)
    if toks[0] != b"P5":
        raise ValueError(f"{path}: not a binary PGM (P5)")
    w, h, maxval = (int(t) for t in toks[1:])
    pos += 1 if data[pos - 1: pos] not in (b"\n", b" ", b"\t") else 0
    wide = maxval > 255
    n_bytes = w * h * (2 if wide else 1)
    if len(data) - pos < n_bytes:
        raise ValueError(f"{path}: {len(data) - pos} bytes of samples, {n_bytes} expected")
    arr = np.frombuffer(data[pos: pos + n_bytes], ">u2" if wide else np.uint8)
    arr = arr.reshape(h, w)
    if wide:
        arr = (arr.astype(np.float32) * (255.0 / maxval)).astype(np.uint8)
    return np.asarray(arr, np.uint8)


def load_image(path: str) -> np.ndarray:
    """Decode one image file to (H, W) uint8 grayscale."""
    if path.lower().endswith(".pgm"):
        return _read_pgm(path)
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("L"), np.uint8)


def _sequence_files(cam_dir: str) -> list:
    fs = [f for f in sorted(os.listdir(cam_dir)) if f.lower().endswith(_IMG_EXTS)]
    if not fs:
        raise FileNotFoundError(f"no image files in {cam_dir}")
    return [os.path.join(cam_dir, f) for f in fs]


def load_sequence_dir(path: str, names=None, limit: int = 0):
    """Load a dataset directory -> (frames (C,T,H,W) uint8, timestamps
    (C,T) float64).  T is the shortest camera's sequence: a tail frame
    dropped on one camera must not desynchronise the set."""
    if names is None:
        names = sorted(d for d in os.listdir(path)
                       if os.path.isdir(os.path.join(path, d)) and not d.startswith("."))
    per_cam, per_ts = [], []
    for name in names:
        cam_dir = os.path.join(path, name)
        files = _sequence_files(cam_dir)
        if limit:
            files = files[:limit]
        per_cam.append(np.stack([load_image(f) for f in files]))
        ts_file = os.path.join(cam_dir, "timestamps.txt")
        if os.path.exists(ts_file):
            with open(ts_file) as f:
                ts = np.asarray([float(ln) for ln in f if ln.strip()],
                                np.float64)[: len(files)]
            if ts.shape[0] != len(files):
                raise ValueError(f"{ts_file}: {ts.shape[0]} timestamps for "
                                 f"{len(files)} frames")
        else:
            ts = np.arange(len(files), dtype=np.float64) / 30.0
        per_ts.append(ts)
    T = min(a.shape[0] for a in per_cam)
    return (np.stack([a[:T] for a in per_cam]), np.stack([t[:T] for t in per_ts]))


def export_sequence_dir(path: str, frames_by_cam, timestamps=None,
                        names=None, fps: float = 30.0, fmt: str = "pgm",
                        rig_doc: dict | None = None):
    """Write (C,T,H,W) uint8 frames as a dataset directory (the inverse of
    ``load_sequence_dir``), and the rig document when one is given."""
    frames = np.asarray(frames_by_cam, np.uint8)
    C, T = frames.shape[:2]
    names = names or [f"camera{c + 1}" for c in range(C)]
    os.makedirs(path, exist_ok=True)
    for c in range(C):
        cam_dir = os.path.join(path, names[c])
        os.makedirs(cam_dir, exist_ok=True)
        for t in range(T):
            fp = os.path.join(cam_dir, f"{t:06d}.{fmt}")
            if fmt == "pgm":
                H, W = frames.shape[2:]
                with open(fp, "wb") as f:
                    f.write(b"P5\n%d %d\n255\n" % (W, H))
                    f.write(frames[c, t].tobytes())
            else:
                from PIL import Image
                Image.fromarray(frames[c, t], "L").save(fp)
        ts = (np.asarray(timestamps[c], np.float64) if timestamps is not None
              else np.arange(T, dtype=np.float64) / fps)
        with open(os.path.join(cam_dir, "timestamps.txt"), "w") as f:
            f.writelines(f"{x:.9f}\n" for x in ts)
    if rig_doc is not None:
        with open(os.path.join(path, "rig.json"), "w") as f:
            json.dump(rig_doc, f, indent=1)
    return path


def load_dataset(path: str, limit: int = 0, device="cuda"):
    """Rig and synchronised frames of a dataset directory in one call ->
    (cams, cam_from_base, H, W, masks, names, frames (C,T,H,W),
    timestamps (C,T)); the rig document is ``<path>/rig.json`` and its
    cameras land on ``device``."""
    from mcptam_tpu_torch.io.rig_config import load_rig

    rig_path = os.path.join(path, "rig.json")
    if not os.path.exists(rig_path):
        raise FileNotFoundError(f"{rig_path} missing: a dataset directory "
                                f"carries its rig document")
    cams, cam_from_base, H, W, masks, names = load_rig(rig_path, device=device)
    frames, stamps = load_sequence_dir(path, names=names, limit=limit)
    if frames.shape[2:] != (H, W):
        raise ValueError(f"dataset images {frames.shape[2:]} do not match the rig's {(H, W)}")
    return cams, cam_from_base, H, W, masks, names, frames, stamps
