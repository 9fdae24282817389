"""Frozen plain copy of the port's FAST front-end wrapper (ops/fast_kernel.py): the plain PyTorch version
only, on every device (the benchmark's reference)."""

from __future__ import annotations

import torch

from plainref.ops.fast import fast_score_image, nonmax_3x3

NBINS = 64  # freq[t] for t in [0, 64): covers the 5..60 adaptive range
MAX_LEVELS = 8  # levels one launch takes (csrc/fast.cu)
# int32 scratch per (level, camera): bin counts of score and nm (65 each),
# the last-block ticket and a pad.  The kernel leaves it zero.
SCRATCH_INTS = 2 * (NBINS + 1) + 2

def _cumfreq(x: torch.Tensor) -> torch.Tensor:
    """(C,H,W) -> (C,NBINS) f32 with [c, t] = #(x > t - 1e-6)."""
    flat = x.reshape(x.shape[0], -1)
    ts = torch.arange(NBINS, dtype=x.dtype, device=x.device) - 1e-6
    return torch.stack(
        [torch.sum(flat > ts[t], -1) for t in range(NBINS)], -1
    ).to(torch.float32)


def fast_frontend_reference(img: torch.Tensor, rows=None):
    """Plain version: (C,H,W) f32 -> (score, nm, freq, freq_nm), the
    histograms over the rows [y0, y1) of ``rows`` (default: all)."""
    y0, y1 = _row_range(rows, img.shape[1])
    score = fast_score_image(img)
    nm = nonmax_3x3(score)
    return score, nm, _cumfreq(score[:, y0:y1]), _cumfreq(nm[:, y0:y1])


def _row_range(rows, H: int) -> tuple:
    """The histogram rows of a level of H rows: ``rows`` = (y0, y1) with
    0 <= y0 <= y1 <= H, or None for all of them."""
    if rows is None:
        return 0, H
    y0, y1 = (int(r) for r in rows)
    if not 0 <= y0 <= y1 <= H:
        raise ValueError(f"histogram rows [{y0}, {y1}) outside a level of {H} rows")
    return y0, y1


def fast_frontend_levels(levels, rows=None) -> list:
    """Pyramid levels, each (C,H_l,W_l) f32 -> per level (score, nm, freq,
    freq_nm), the histograms over the rows ``rows`` gives each level."""
    levels = list(levels)
    rows = [None] * len(levels) if rows is None else list(rows)
    return [fast_frontend_reference(p, _row_range(r, p.shape[-2]))
            for p, r in zip(levels, rows)]


def fast_frontend(img: torch.Tensor):
    return fast_frontend_levels([img])[0]
