"""Frozen plain copy of the port's SPD solve (core/spd.py): the plain PyTorch version
only, on every device (the benchmark's reference)."""

from __future__ import annotations

import torch


def spd_solve_reference(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Plain version: the stock dense solver."""
    return torch.linalg.solve(A, B)


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the dense SPD system ``A x = b`` (b may be (n,) or (n, m))."""
    vec = b.ndim == 1
    B = b[:, None] if vec else b
    X = spd_solve_reference(A, B)
    return X[:, 0] if vec else X
