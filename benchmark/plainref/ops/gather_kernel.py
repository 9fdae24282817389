"""Frozen plain copy of the port's window gather wrapper (ops/gather_kernel.py): the plain PyTorch version
only, on every device (the benchmark's reference)."""

from __future__ import annotations

import torch



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
    return gather_windows_reference(plane, rows, cols, G)
