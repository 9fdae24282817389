"""Build and load the native synchronised frame queue (port of the
framequeue half of mcptam_tpu/native/build.py).

``g++`` compiles ``native/framequeue.cc`` at first use into
``mcptam_tpu_torch/_build/``; the library is loaded with ctypes, every
entry point's argument and result types declared.  Nothing is built at
import time.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "framequeue.cc"
BUILD_DIR = SOURCE.parent.parent / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None


def _compile() -> Path:
    """The shared library, compiled unless it is newer than its source.
    Written under a temporary name and renamed, so that processes building
    at once never load a half-written file."""
    out = BUILD_DIR / "libframequeue.so"
    if out.exists() and out.stat().st_mtime >= SOURCE.stat().st_mtime:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                   check=True, capture_output=True)
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The frame queue's library, built at the first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_compile()))
        lib.fq_create.restype = ctypes.c_void_p
        lib.fq_create.argtypes = [
            ctypes.c_int, ctypes.c_uint64, ctypes.c_double, ctypes.c_uint64,
        ]
        lib.fq_destroy.restype = None
        lib.fq_destroy.argtypes = [ctypes.c_void_p]
        lib.fq_push.restype = None
        lib.fq_push.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.fq_get_synced.restype = ctypes.c_int
        lib.fq_get_synced.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ]
        lib.fq_dropped.restype = ctypes.c_uint64
        lib.fq_dropped.argtypes = [ctypes.c_void_p]
        lib.fq_set_dynamic.restype = None
        lib.fq_set_dynamic.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.fq_effective_tol.restype = ctypes.c_double
        lib.fq_effective_tol.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib
