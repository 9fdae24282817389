"""Frozen plain copy of the port's half-sample wrapper (ops/halfsample_kernel.py): the plain PyTorch version
only, on every device (the benchmark's reference)."""

from __future__ import annotations

import torch


def half_sample_kernel(img: torch.Tensor) -> torch.Tensor:
    from plainref.ops.pyramid import half_sample_reference
    return half_sample_reference(img)
