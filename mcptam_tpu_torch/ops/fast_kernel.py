"""FAST-10 front-end: score + 3x3 nonmax + threshold histograms in one pass
(port of mcptam_tpu/ops/fast_pallas.py::fast_frontend).

A CUDA tensor launches the hand-written kernel ``csrc/fast.cu``; a CPU
tensor takes ``fast_frontend_reference``, the plain PyTorch version with
identical outputs.  There is no other route.
"""

from __future__ import annotations

import torch

from mcptam_tpu_torch import backend
from mcptam_tpu_torch.ops.fast import fast_score_image, nonmax_3x3

NBINS = 64  # freq[t] for t in [0, 64): covers the 5..60 adaptive range


def _cumfreq(x: torch.Tensor) -> torch.Tensor:
    """(C,H,W) -> (C,NBINS) f32 with [c, t] = #(x > t - 1e-6)."""
    flat = x.reshape(x.shape[0], -1)
    ts = torch.arange(NBINS, dtype=x.dtype, device=x.device) - 1e-6
    return torch.stack(
        [torch.sum(flat > ts[t], -1) for t in range(NBINS)], -1
    ).to(torch.float32)


def fast_frontend_reference(img: torch.Tensor):
    """Plain version: (C,H,W) f32 -> (score, nm, freq, freq_nm)."""
    score = fast_score_image(img)
    nm = nonmax_3x3(score)
    return score, nm, _cumfreq(score), _cumfreq(nm)


def fast_frontend(img: torch.Tensor):
    """(C,H,W) f32 image -> (score (C,H,W), nm (C,H,W), freq (C,NBINS),
    freq_nm (C,NBINS)).

    score/nm: FAST-10 max-threshold score and its strict 3x3 nonmax
    (earlier raster pixel wins ties); freq[c, t] = #(score > t - 1e-6) and
    freq_nm the same over nm, over the in-image pixels."""
    if img.device.type == "cpu":
        return fast_frontend_reference(img)
    if img.device.type != "cuda":
        raise ValueError(f"fast_frontend: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.ndim != 3 or not img.is_contiguous():
        raise ValueError("fast_frontend takes a contiguous (C,H,W) float32 "
                         f"tensor, got {img.dtype} {tuple(img.shape)}")
    from mcptam_tpu_torch.csrc._build import check, load

    lib = load()
    C, H, W = img.shape
    score = torch.empty_like(img)
    nm = torch.empty_like(img)
    freq = torch.empty((C, NBINS), dtype=torch.float32, device=img.device)
    freq_nm = torch.empty_like(freq)
    # per-camera bin counts of score and nm, zeroed by the entry point
    hist = torch.empty((2, C, NBINS + 1), dtype=torch.int32, device=img.device)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    err = lib.mcptam_fast_frontend(
        img.data_ptr(), score.data_ptr(), nm.data_ptr(), freq.data_ptr(),
        freq_nm.data_ptr(), hist.data_ptr(), C, H, W, stream,
    )
    check(err, "fast_frontend")
    backend.LAUNCHES["fast_frontend"] += 1
    return score, nm, freq, freq_nm

