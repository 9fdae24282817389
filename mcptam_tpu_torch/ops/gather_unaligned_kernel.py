"""Unaligned window gather with zero-filled overrun (port of
scripts/profile_gather.py::gather_unaligned, K8).

Window k copies the (G,G) block of an (HH,AW) f32 plane that starts at
``r = clip(rows[k], 0, HH)``, ``c = clip(cols[k], 0, AW)``; pixels past the
last row or column are zero.  K2 (``ops/gather_kernel.py``) differs: it
clamps the start so that the window fits, as ``lax.dynamic_slice`` does.
A CUDA tensor launches the hand-written kernel ``csrc/gather_unaligned.cu``;
a CPU tensor takes ``gather_unaligned_reference``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mcptam_tpu_torch import backend


def gather_unaligned_reference(plane: torch.Tensor, rows: torch.Tensor,
                               cols: torch.Tensor, G: int) -> torch.Tensor:
    """Plain version, as the TPU script computes it: pad the plane with G
    zero rows and columns, clip the starts into the padding, slice."""
    HH, AW = plane.shape
    padded = F.pad(plane.to(torch.float32), (0, G, 0, G))
    r0 = torch.clamp(rows.to(torch.int64), 0, HH)
    c0 = torch.clamp(cols.to(torch.int64), 0, AW)
    ar = torch.arange(G, device=plane.device)
    return padded[(r0[:, None] + ar)[:, :, None], (c0[:, None] + ar)[:, None, :]]


def gather_unaligned(plane: torch.Tensor, rows: torch.Tensor,
                     cols: torch.Tensor, G: int) -> torch.Tensor:
    """(HH,AW) f32 plane + (K,) integer window starts -> (K,G,G) f32."""
    if plane.device.type == "cpu":
        return gather_unaligned_reference(plane, rows, cols, G)
    if plane.device.type != "cuda":
        raise ValueError(f"gather_unaligned: unsupported device {plane.device}")
    if plane.dtype != torch.float32 or plane.ndim != 2 or not plane.is_contiguous():
        raise ValueError("gather_unaligned takes a contiguous 2-D float32 plane, "
                         f"got {plane.dtype} {tuple(plane.shape)}")
    if not 0 < G <= 80 or rows.shape != cols.shape or rows.ndim != 1:
        raise ValueError(f"gather_unaligned: bad window {G} or starts "
                         f"{tuple(rows.shape)}/{tuple(cols.shape)}")
    if (rows.device != plane.device or cols.device != plane.device
            or rows.is_floating_point() or cols.is_floating_point()):
        raise ValueError("gather_unaligned: starts must be integer tensors on "
                         "the plane's device")
    from mcptam_tpu_torch.csrc._build import check, load

    lib = load()
    rows32 = rows.to(torch.int32).contiguous()
    cols32 = cols.to(torch.int32).contiguous()
    HH, AW = plane.shape
    K = rows32.shape[0]
    out = torch.empty((K, G, G), dtype=torch.float32, device=plane.device)
    stream = torch.cuda.current_stream(plane.device).cuda_stream
    err = lib.mcptam_gather_unaligned(
        plane.data_ptr(), rows32.data_ptr(), cols32.data_ptr(), out.data_ptr(),
        K, HH, AW, G, stream,
    )
    check(err, "gather_unaligned")
    backend.count_launch("gather_unaligned")
    return out
