"""2x2 box half-sample on the card (port of the Pallas half-sample
prototypes, scripts/test_pallas_halfsample.py: K6 and K7).

``half_sample_kernel`` launches the hand-written kernel
``csrc/halfsample.cu``; ``ops/pyramid.py::half_sample`` dispatches to it for
a CUDA tensor and to ``half_sample_reference`` for a CPU one.
"""

from __future__ import annotations

import torch

from mcptam_tpu_torch import backend


def half_sample_kernel(img: torch.Tensor) -> torch.Tensor:
    """(...,H,W) f32 CUDA tensor -> (...,H//2,W//2): an odd last row or
    column is dropped.  Bit-identical to the plain version."""
    if img.device.type != "cuda":
        raise ValueError(f"half_sample_kernel: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.ndim < 2 or not img.is_contiguous():
        raise ValueError("half_sample_kernel takes a contiguous float32 "
                         f"(...,H,W) tensor, got {img.dtype} {tuple(img.shape)}")
    H, W = img.shape[-2], img.shape[-1]
    if H < 2 or W < 2:
        raise ValueError(f"half_sample_kernel: image {H}x{W} is too small")
    lead = img.shape[:-2]
    N = 1
    for d in lead:
        N *= d
    from mcptam_tpu_torch.csrc._build import check, load

    lib = load()
    out = torch.empty(lead + (H // 2, W // 2), dtype=torch.float32, device=img.device)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    err = lib.mcptam_half_sample(img.data_ptr(), out.data_ptr(), N, H, W, stream)
    check(err, "half_sample")
    backend.count_launch("half_sample")
    return out
