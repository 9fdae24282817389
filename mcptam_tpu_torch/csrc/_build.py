"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``), at first
use, into ``mcptam_tpu_torch/_build/``: one ``nvcc -c`` per source, all
started together, then one link into a shared library with a plain C
interface.  The library's file name carries a hash of the sources and
flags, so a changed source builds anew.  It is loaded with ctypes; every
pointer and the stream travel as ``c_void_p``.

Nothing is built or loaded at import time: the CPU tests import every
module of the port on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent
BUILD_DIR = CSRC.parent / "_build"
SOURCES = ("common.cu", "fast.cu", "gather.cu", "esm.cu", "spd.cu",
           "halfsample.cu", "gather_unaligned.cu", "search.cu", "minipatch.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_size_t
# C entry point -> argument types; each returns a cudaError_t as int
ENTRY_POINTS = {
    "mcptam_fast_frontend_levels": [_P] * 2 + [_I] * 2 + [_P] * 2,
    "mcptam_gather_windows_f32": [_P] * 4 + [_I] * 4 + [_P],
    "mcptam_gather_windows_u8": [_P] * 4 + [_I] * 4 + [_P],
    "mcptam_esm_align_all": [_P] * 6 + [_I] * 2 + [_P],
    "mcptam_spd_solve": [_P] * 3 + [_I] * 3 + [_P],
    "mcptam_spd_solve_global": [_P] * 4 + [_I] * 2 + [_S, _P],
    "mcptam_spd_global_plan": [_I] * 2 + [_P],
    "mcptam_half_sample": [_P] * 2 + [_I] * 3 + [_P],
    "mcptam_gather_unaligned": [_P] * 4 + [_I] * 4 + [_P],
    "mcptam_search_patches": [_P] * 9 + [_I, _P, _F, _F] + [_I] * 4 + [_P] * 9,
    "mcptam_stability_search": [_P] * 5 + [_I] * 3 + [_F] * 2 + [_P] * 6,
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libmcptam_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple:
    """Compile the library unless this source hash is already built: every
    source in its own nvcc process, all at once, then one link.  Returns
    (path, compiler log); the log holds ptxas' register and shared-memory
    report of every kernel, empty when nothing was built."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{Path(s).stem}.o") for s in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for src, obj in zip(SOURCES, objs)]
    log, failed = [], []
    for src, proc in zip(SOURCES, procs):
        stdout, stderr = proc.communicate()
        log.append(stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"{src} ({proc.returncode}):\n{stderr}")
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        proc = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out, "".join(log)


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.mcptam_error_string.argtypes = [ctypes.c_int]
            lib.mcptam_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = load().mcptam_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
