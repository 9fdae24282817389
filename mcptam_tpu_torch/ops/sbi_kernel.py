"""All ESM iterations for all cameras in one launch (port of
mcptam_tpu/ops/sbi_pallas.py::esm_align_all).

A CUDA tensor launches the hand-written kernel ``csrc/esm.cu``; a CPU
tensor takes ``esm_align``, the plain PyTorch version (ops/sbi.py).
"""

from __future__ import annotations

import torch

from mcptam_tpu_torch import backend
from mcptam_tpu_torch.ops.sbi import COLS, ROWS, esm_align

__all__ = ["esm_align", "esm_align_all"]


def esm_align_all(cur, target, gx, gy, n_iterations: int = 9):
    """(C,30,40) current/target templates and target gradients ->
    (se2 (C,4) = (cos, sin, tx, ty), score (C,))."""
    if cur.device.type == "cpu":
        return esm_align(cur, target, gx, gy, n_iterations)
    if cur.device.type != "cuda":
        raise ValueError(f"esm_align_all: unsupported device {cur.device}")
    C = cur.shape[0]
    for a in (cur, target, gx, gy):
        if (a.dtype != torch.float32 or tuple(a.shape) != (C, ROWS, COLS)
                or not a.is_contiguous() or a.device != cur.device):
            raise ValueError("esm_align_all takes contiguous (C,30,40) float32 "
                             f"tensors on one device, got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")
    from mcptam_tpu_torch.csrc._build import check, load

    lib = load()
    se2 = torch.empty((C, 4), dtype=torch.float32, device=cur.device)
    score = torch.empty((C,), dtype=torch.float32, device=cur.device)
    stream = torch.cuda.current_stream(cur.device).cuda_stream
    err = lib.mcptam_esm_align_all(
        cur.data_ptr(), target.data_ptr(), gx.data_ptr(), gy.data_ptr(),
        se2.data_ptr(), score.data_ptr(), C, n_iterations, stream,
    )
    check(err, "esm_align_all")
    backend.count_launch("esm_align_all")
    return se2, score
