"""Frozen plain copy of the port's ESM wrapper (ops/sbi_kernel.py): the plain PyTorch version
only, on every device (the benchmark's reference)."""

from __future__ import annotations

from plainref.ops.sbi import COLS, ROWS, esm_align  # noqa: F401

__all__ = ["esm_align", "esm_align_all"]


def esm_align_all(cur, target, gx, gy, n_iterations: int = 9):
    return esm_align(cur, target, gx, gy, n_iterations)
