"""Array-payload codec of the client/server map protocol (port of
mcptam_tpu/system/netcodec.py; numpy and zlib, Pillow for JPEG).

A message is a named set of numpy arrays packed into one binary blob,
zlib-compressed (tag ``Z``) or raw (tag ``R``); slot indices are globally
consistent by construction, so no id translation dictionaries are needed
(the reference's ROS messages carry string-id dictionaries,
src/NetworkManager.cc:741-805, include/mcptam/Dictionary.h).  The format is
the JAX package's, byte for byte: a process of either package reads the
other's messages.

Keyframe imagery can ride as per-camera JPEG planes at the reference's
quality 90 (src/NetworkManager.cc:804-805), lossy like the reference, which
re-derives server-side imagery from the decoded image.  JPEG needs Pillow,
imported softly as the reference does: without it a key asked for as JPEG
travels as lossless planes, and ``message_encodings`` says which a message
carried.  The receiver decodes either.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np

try:
    from PIL import Image as _PILImage
except ImportError:  # the reference's soft rule: ship lossless planes
    _PILImage = None

JPEG_QUALITY = 90  # reference NetworkManager JPEG quality (:804-805)

# ModifyMap action vocabulary (reference srv/ModifyMap.srv)
ACTION_ADD = 1
ACTION_DELETE = 2
ACTION_UPDATE = 3
ACTION_OUTLIERS = 4
ACTION_INIT = 5
ACTION_RESET = 6
ACTION_STATE = 7
# client -> server operator-monitoring relay (tracker state + small image;
# the reference server subscribes to the client's system_info/small_image
# topics for the off-board operator, src/SystemServer.cc:113-136)
ACTION_MONITOR = 8

_DTYPES = [
    np.dtype(np.uint8), np.dtype(np.int32), np.dtype(np.int64),
    np.dtype(np.float32), np.dtype(np.float64), np.dtype(np.bool_),
    np.dtype(np.uint32),
]
_DTYPE_CODE = {dt: i for i, dt in enumerate(_DTYPES)}

_FLAG_JPEG = 0x80  # high bit of the dtype-code byte: payload is JPEG planes


def _jpeg_encode_planes(arr: np.ndarray, quality: int) -> bytes:
    planes = arr.reshape((-1,) + arr.shape[-2:])
    blobs = []
    for p in planes:
        buf = io.BytesIO()
        _PILImage.fromarray(p, mode="L").save(buf, "JPEG", quality=int(quality))
        blobs.append(buf.getvalue())
    return struct.pack("<I", len(blobs)) + b"".join(
        struct.pack("<I", len(b)) + b for b in blobs)


def _jpeg_end(body: bytes, off: int) -> int:
    """Offset just past the JPEG planes that start at ``off``."""
    (n,) = struct.unpack_from("<I", body, off)
    off += 4
    for _ in range(n):
        (ln,) = struct.unpack_from("<I", body, off)
        off += 4 + ln
    return off


def _jpeg_decode_planes(body: bytes, off: int, shape) -> np.ndarray:
    if _PILImage is None:
        raise RuntimeError("a JPEG-encoded array arrived, and Pillow is not importable")
    (n,) = struct.unpack_from("<I", body, off)
    off += 4
    planes = []
    for _ in range(n):
        (ln,) = struct.unpack_from("<I", body, off)
        off += 4
        img = _PILImage.open(io.BytesIO(body[off: off + ln]))
        planes.append(np.asarray(img, np.uint8))
        off += ln
    return np.stack(planes).reshape(shape)


def pack_arrays(arrays: dict, compress: bool = True,
                jpeg_keys=(), jpeg_quality: int = JPEG_QUALITY) -> bytes:
    """Pack a dict of numpy arrays.  Keys in ``jpeg_keys`` holding uint8
    (..., H, W) arrays travel as JPEG planes when Pillow is importable.
    Dtypes outside the codec's set travel as float32; a 0-d array travels
    as shape (1,)."""
    parts = [struct.pack("<I", len(arrays))]
    for key, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        if arr.dtype not in _DTYPE_CODE:
            arr = arr.astype(np.float32)
        kb = key.encode()
        parts.append(struct.pack("<H", len(kb)))
        parts.append(kb)
        as_jpeg = (
            key in jpeg_keys and jpeg_quality > 0 and _PILImage is not None
            and arr.dtype == np.uint8 and arr.ndim >= 2
            and arr.shape[-2] > 0 and arr.shape[-1] > 0
        )
        parts.append(struct.pack(
            "<BB", _DTYPE_CODE[arr.dtype] | (_FLAG_JPEG if as_jpeg else 0), arr.ndim))
        parts.append(struct.pack(f"<{arr.ndim}Q", *arr.shape))
        parts.append(_jpeg_encode_planes(arr, jpeg_quality) if as_jpeg
                     else arr.tobytes())
    raw = b"".join(parts)
    if compress:
        return b"Z" + zlib.compress(raw, 3)
    return b"R" + raw


def _entries(blob: bytes):
    """(body, [(key, dtype code, shape, payload start, payload end)])."""
    tag, body = blob[:1], blob[1:]
    if tag == b"Z":
        body = zlib.decompress(body)
    off = 0
    (n,) = struct.unpack_from("<I", body, off)
    off += 4
    out = []
    for _ in range(n):
        (klen,) = struct.unpack_from("<H", body, off)
        off += 2
        key = body[off: off + klen].decode()
        off += klen
        code, ndim = struct.unpack_from("<BB", body, off)
        off += 2
        shape = struct.unpack_from(f"<{ndim}Q", body, off)
        off += 8 * ndim
        if code & _FLAG_JPEG:
            end = _jpeg_end(body, off)
        else:
            count = int(np.prod(shape)) if ndim else 1
            end = off + count * _DTYPES[code].itemsize
        out.append((key, code, shape, off, end))
        off = end
    return body, out


def unpack_arrays(blob: bytes) -> dict:
    body, entries = _entries(blob)
    out = {}
    for key, code, shape, start, end in entries:
        if code & _FLAG_JPEG:
            out[key] = _jpeg_decode_planes(body, start, shape)
        else:
            dt = _DTYPES[code]
            count = (end - start) // dt.itemsize
            out[key] = np.frombuffer(body, dt, count, start).reshape(shape).copy()
    return out


def message_encodings(blob: bytes) -> dict:
    """{key: "jpeg" or "raw"}: how each array of a packed message travelled."""
    _, entries = _entries(blob)
    return {key: "jpeg" if code & _FLAG_JPEG else "raw"
            for key, code, _, _, _ in entries}
