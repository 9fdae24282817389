"""Build and load the native runtime libraries (port of
mcptam_tpu/native/build.py): the synchronised frame queue
(``framequeue.cc``) and the framed-TCP net manager (``netmanager.cc``).

``g++`` compiles a library at its first use into
``mcptam_tpu_torch/_build/``; it is loaded with ctypes, every entry point's
argument and result types declared.  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

SOURCE_DIR = Path(__file__).resolve().parent
SOURCES = {"framequeue": "framequeue.cc", "netmanager": "netmanager.cc"}
BUILD_DIR = SOURCE_DIR.parent / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_libs: dict = {}


def _compile(name: str) -> Path:
    """The shared library ``lib<name>.so``, compiled unless it is newer than
    its source.  Written under a temporary name and renamed, so that
    processes building at once never load a half-written file."""
    src = SOURCE_DIR / SOURCES[name]
    out = BUILD_DIR / f"lib{name}.so"
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", *CXX_FLAGS, str(src), "-o", str(tmp)],
                   check=True, capture_output=True)
    os.replace(tmp, out)
    return out


def _declare(lib, name: str, restype, *argtypes):
    fn = getattr(lib, name)
    fn.restype = restype
    fn.argtypes = list(argtypes)


def _declare_framequeue(lib):
    vp, u8p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)
    _declare(lib, "fq_create", vp, ctypes.c_int, ctypes.c_uint64, ctypes.c_double,
             ctypes.c_uint64)
    _declare(lib, "fq_destroy", None, vp)
    _declare(lib, "fq_push", None, vp, ctypes.c_int, ctypes.c_double, u8p)
    _declare(lib, "fq_get_synced", ctypes.c_int, vp, u8p,
             ctypes.POINTER(ctypes.c_double), ctypes.c_int)
    _declare(lib, "fq_dropped", ctypes.c_uint64, vp)
    _declare(lib, "fq_set_dynamic", None, vp, ctypes.c_int)
    _declare(lib, "fq_effective_tol", ctypes.c_double, vp)


def _declare_netmanager(lib):
    vp, u8p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)
    _declare(lib, "nm_create_server", vp, ctypes.c_uint16)
    _declare(lib, "nm_create_client", vp, ctypes.c_char_p, ctypes.c_uint16)
    _declare(lib, "nm_destroy", None, vp)
    _declare(lib, "nm_send", None, vp, ctypes.c_uint32, u8p, ctypes.c_uint64)
    _declare(lib, "nm_poll", ctypes.c_int64, vp, ctypes.POINTER(ctypes.c_uint32),
             u8p, ctypes.c_uint64, ctypes.c_int)
    _declare(lib, "nm_peek_size", ctypes.c_int64, vp)
    _declare(lib, "nm_port", ctypes.c_uint16, vp)
    _declare(lib, "nm_stats", None, vp, ctypes.POINTER(ctypes.c_uint64))
    _declare(lib, "nm_break", None, vp)


_DECLARE = {"framequeue": _declare_framequeue, "netmanager": _declare_netmanager}


def load(name: str) -> ctypes.CDLL:
    """The library ``name`` (``"framequeue"`` or ``"netmanager"``), built at
    its first call."""
    if name not in SOURCES:
        raise ValueError(f"unknown native library {name!r}; have {sorted(SOURCES)}")
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_compile(name)))
            _DECLARE[name](lib)
            _libs[name] = lib
        return _libs[name]
