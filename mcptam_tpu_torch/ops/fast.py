"""FAST-10 scoring, nonmax, adaptive threshold and candidate selection
(port of the tracking subset of mcptam_tpu/ops/fast.py; ref libCVD FAST as
used by src/KeyFrame.cc:247-452), and the top-k corner list the
checkerboard detector takes (calib/corners.py).

``fast_score_image`` and ``nonmax_3x3`` are the plain versions that the
CUDA front-end kernel (csrc/fast.cu) is held against; the rest is the
threshold and candidate logic that consumes the kernel's histograms.
Everything here is exact in f32: scores are min/max of pixel differences,
histograms are counts, thresholds are integers.
"""

from __future__ import annotations

import torch

# Bresenham circle of radius 3, clockwise from 12 o'clock, in (dy, dx)
RING_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

BORDER = 3


def _shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = img[y+dy, x+dx] with wrap-around (callers mask borders)."""
    return torch.roll(img, shifts=(-dy, -dx), dims=(-2, -1))


def _circular_window_min(d: torch.Tensor) -> torch.Tensor:
    """(...,16) ring values -> min over the 10 contiguous entries starting
    at each position (circular)."""
    m2 = torch.minimum(d, torch.roll(d, -1, -1))
    m4 = torch.minimum(m2, torch.roll(m2, -2, -1))
    m8 = torch.minimum(m4, torch.roll(m4, -4, -1))
    return torch.minimum(m8, torch.roll(m2, -8, -1))


def fast_score_image(img: torch.Tensor) -> torch.Tensor:
    """FAST-10 max-threshold score of every pixel of (...,H,W):
    score > t  <=>  the pixel passes the segment test at threshold t.
    The 3-px border scores 0."""
    rings = torch.stack([_shift2d(img, dy, dx) for (dy, dx) in RING_OFFSETS], -1)
    d = rings - img[..., None]
    bright = torch.amax(_circular_window_min(d), -1)
    dark = torch.amax(_circular_window_min(-d), -1)
    score = torch.clamp(torch.maximum(bright, dark), min=0.0)
    H, W = img.shape[-2], img.shape[-1]
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    inb = (ys >= BORDER) & (ys < H - BORDER) & (xs >= BORDER) & (xs < W - BORDER)
    return torch.where(inb, score, torch.zeros_like(score))


def nonmax_3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep strict maxima of the 3x3 neighbourhood, the earlier raster
    pixel winning ties; zero elsewhere (CVD::fast_nonmax)."""
    keep = torch.ones(score.shape, dtype=torch.bool, device=score.device)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            s = _shift2d(score, dy, dx)
            if dy < 0 or (dy == 0 and dx < 0):
                keep &= score > s
            else:
                keep &= score >= s
    return torch.where(keep, score, torch.zeros_like(score))


def adaptive_threshold_from_freq(freq: torch.Tensor, n_pixels: int,
                                 min_thresh: int = 5, max_thresh: int = 60,
                                 target_divisor: float = 500.0) -> torch.Tensor:
    """Knee-point FAST threshold from the cumulative histogram
    freq[..., t] = #(score > t) (src/KeyFrame.cc:247-316)."""
    f = freq[..., min_thresh : max_thresh + 1].to(torch.float32)
    n = f.shape[-1]
    deriv = torch.cat([
        f[..., 1:2] - f[..., 0:1],
        (f[..., 2:] - f[..., :-2]) * 0.5,
        f[..., -1:] - f[..., -2:-1],
    ], -1)
    exceeded = deriv > (-n_pixels / target_divisor)
    idx = torch.argmax(exceeded.to(torch.int32), -1)
    idx = torch.where(torch.any(exceeded, -1), idx, torch.full_like(idx, n - 1))
    return (min_thresh + idx).to(torch.float32)


def cutoff_from_freq(freq_nm: torch.Tensor, thresholds: torch.Tensor, k: int):
    """Smallest integer cutoff >= threshold whose surviving nonmax-corner
    count (from freq_nm (...,NBINS)) fits the capacity k."""
    nbins = freq_nm.shape[-1]
    t_axis = torch.arange(nbins, dtype=torch.float32, device=freq_nm.device)
    fits = (freq_nm <= k) & (t_axis >= torch.ceil(thresholds)[..., None])
    has = torch.any(fits, -1)
    first = torch.argmax(fits.to(torch.int32), -1)
    cut = torch.where(has, first, torch.full_like(first, nbins - 1))
    return torch.maximum(cut.to(torch.float32), thresholds)


def select_corners_cutoff(nm: torch.Tensor, mask: torch.Tensor,
                          cutoff: torch.Tensor, k: int, floor: torch.Tensor):
    """Sort-free candidate selection, batched over a leading camera axis:
    nonmax corners above ``cutoff`` (then the boundary bin down to
    ``floor``) compacted in raster order into k slots
    (src/KeyFrame.cc:363-452).

    nm, mask: (C,H,W); cutoff, floor: (C,).
    Returns (xy (C,k,2) int32, scores (C,k), valid (C,k))."""
    C, H, W = nm.shape
    nmf = nm.reshape(C, -1)
    maskf = mask.reshape(C, -1)
    m1 = (nmf > (cutoff - 1e-6)[:, None]) & maskf
    lo = torch.maximum(cutoff - 1.0, floor) - 1e-6
    m2 = (nmf > lo[:, None]) & maskf & ~m1
    m1i = m1.to(torch.int32)
    m2i = m2.to(torch.int32)
    n1 = torch.sum(m1i, -1, keepdim=True)
    rank1 = torch.cumsum(m1i, -1) - 1
    rank2 = n1 + torch.cumsum(m2i, -1) - 1
    rank = torch.where(m1, rank1, rank2)
    sel = (m1 | m2) & (rank < k)
    # slot k is the sink for everything not selected; it is cut off below
    tgt = torch.where(sel, rank, torch.full_like(rank, k)).to(torch.int64)
    pix = torch.arange(H * W, dtype=torch.int64, device=nm.device).expand(C, -1)
    idx = torch.zeros((C, k + 1), dtype=torch.int64, device=nm.device)
    idx = idx.scatter(1, tgt, pix)[:, :k]
    n_sel = torch.clamp(n1[:, 0] + torch.sum(m2i, -1), max=k)
    valid = torch.arange(k, device=nm.device)[None, :] < n_sel[:, None]
    xy = torch.stack([idx % W, torch.div(idx, W, rounding_mode="floor")], -1)
    score = torch.gather(nmf, 1, idx) * valid
    return xy.to(torch.int32), score, valid


def topk_corners(score: torch.Tensor, k: int, min_score=0.0):
    """The k highest-scoring pixels of an (H,W) score image as a
    fixed-capacity corner list: (xy (k,2) int32, scores (k,), valid (k,)).
    A stable descending sort keeps tied scores lowest index first, as
    jax.lax.top_k does (torch.topk promises no order among ties)."""
    W = score.shape[-1]
    vals, idx = torch.sort(score.reshape(-1), descending=True, stable=True)
    vals, idx = vals[:k], idx[:k]
    xy = torch.stack([idx % W, torch.div(idx, W, rounding_mode="floor")], -1)
    return xy.to(torch.int32), vals, vals > min_score
