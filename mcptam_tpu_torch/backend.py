"""Kernel launch counters.

Each kernel wrapper adds one to its counter where it launches its CUDA
kernel, and nowhere else: a CPU tensor that takes the plain version counts
nothing.  A run can therefore show which kernels its main path really went
through — the reference's ``kernel_report`` (mcptam_tpu/backend.py) only
reports which tier a dispatch site *would* take.
"""

from __future__ import annotations

import threading

# kernel name -> launches since the last reset; one plain integer per wrapper
LAUNCHES = {
    "fast_frontend": 0,   # ops/fast_kernel.py, csrc/fast.cu
    "gather_windows": 0,  # ops/gather_kernel.py, csrc/gather.cu
    "search_patches": 0,  # ops/search_kernel.py, csrc/search.cu (the tracker's K2)
    "esm_align_all": 0,   # ops/sbi_kernel.py, csrc/esm.cu
    "spd_solve_blocked": 0,  # core/spd.py, csrc/spd.cu (K4)
    "spd_solve_blocked_global": 0,  # core/spd.py, csrc/spd.cu (K4's global path)
    "spd_solve_simple": 0,   # core/spd.py, csrc/spd.cu (K5)
    "half_sample": 0,        # ops/halfsample_kernel.py, csrc/halfsample.cu (K6/K7)
    "gather_unaligned": 0,   # ops/gather_unaligned_kernel.py, csrc/gather_unaligned.cu (K8)
    "stability_filter": 0,   # ops/minipatch_kernel.py, csrc/minipatch.cu (K8 with MiniPatch's search)
}


_lock = threading.Lock()   # a client's tracker and a map server may share a process


def count_launch(name: str) -> None:
    """One launch of kernel ``name``: its wrapper calls this where it
    launches the kernel."""
    with _lock:
        LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def kernel_report() -> dict:
    """Launch count of every kernel since the last reset."""
    with _lock:
        return dict(LAUNCHES)
