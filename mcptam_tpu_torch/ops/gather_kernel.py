"""Window gather: K (G,G) windows out of a 2-D plane at per-window starts
(port of mcptam_tpu/ops/pallas_gather.py::gather_windows_pallas and of the
``dynamic_slice`` path of ops/batch_patch.py::_gather_plane).

A CUDA tensor launches the hand-written kernel ``csrc/gather.cu`` (f32 and
uint8 planes); a CPU tensor takes ``gather_windows_reference``.  Starts are
clamped into the plane the way ``lax.dynamic_slice`` clamps them.
"""

from __future__ import annotations

import torch

from mcptam_tpu_torch import backend


def gather_windows_reference(plane: torch.Tensor, rows: torch.Tensor,
                             cols: torch.Tensor, G: int) -> torch.Tensor:
    """Plain version: (HH,AW) plane, (K,) starts -> (K,G,G) f32."""
    HH, AW = plane.shape
    r0 = torch.clamp(rows.to(torch.int64), 0, HH - G)
    c0 = torch.clamp(cols.to(torch.int64), 0, AW - G)
    ar = torch.arange(G, device=plane.device)
    return plane[
        (r0[:, None] + ar)[:, :, None], (c0[:, None] + ar)[:, None, :]
    ].to(torch.float32)


def gather_windows(plane: torch.Tensor, rows: torch.Tensor,
                   cols: torch.Tensor, G: int) -> torch.Tensor:
    """(HH,AW) f32 or uint8 plane + (K,) window starts -> (K,G,G) f32."""
    if plane.device.type == "cpu":
        return gather_windows_reference(plane, rows, cols, G)
    if plane.device.type != "cuda":
        raise ValueError(f"gather_windows: unsupported device {plane.device}")
    entry = {torch.float32: "mcptam_gather_windows_f32",
             torch.uint8: "mcptam_gather_windows_u8"}.get(plane.dtype)
    if entry is None or plane.ndim != 2 or not plane.is_contiguous():
        raise ValueError("gather_windows takes a contiguous 2-D float32 or "
                         f"uint8 plane, got {plane.dtype} {tuple(plane.shape)}")
    HH, AW = plane.shape
    if not (0 < G <= HH and G <= AW) or rows.shape != cols.shape or rows.ndim != 1:
        raise ValueError(f"gather_windows: bad window {G} for plane "
                         f"{tuple(plane.shape)} or starts {tuple(rows.shape)}")
    if (rows.device != plane.device or cols.device != plane.device
            or rows.is_floating_point() or cols.is_floating_point()):
        raise ValueError("gather_windows: starts must be integer tensors on "
                         "the plane's device")
    from mcptam_tpu_torch.csrc._build import check, load

    lib = load()
    rows32 = rows.to(torch.int32).contiguous()
    cols32 = cols.to(torch.int32).contiguous()
    K = rows32.shape[0]
    out = torch.empty((K, G, G), dtype=torch.float32, device=plane.device)
    stream = torch.cuda.current_stream(plane.device).cuda_stream
    err = getattr(lib, entry)(
        plane.data_ptr(), rows32.data_ptr(), cols32.data_ptr(),
        out.data_ptr(), K, HH, AW, G, stream,
    )
    check(err, "gather_windows")
    backend.count_launch("gather_windows")
    return out
