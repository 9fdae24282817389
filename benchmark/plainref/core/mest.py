"""Robust M-estimators (port of mcptam_tpu/core/mest.py, ref
include/mcptam/MEstimator.h): the Huber and Tukey weights and objectives
the tracker and bundle adjustment use, and the sort-free masked medians."""

from __future__ import annotations

import torch

from plainref.parallel.collectives import all_reduce

TUKEY = "tukey"
HUBER = "huber"


def masked_median_bisect(x: torch.Tensor, mask: torch.Tensor,
                         iters: int = 26) -> torch.Tensor:
    """Lower median of x where mask along the last axis, by bisection
    counting (fixed iteration count, no sort and no host sync)."""
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    lo = torch.amin(torch.where(mask, x, inf), -1)
    hi = torch.amax(torch.where(mask, x, -inf), -1)
    n = torch.sum(mask, -1)
    ok = n > 0
    zero = torch.zeros_like(lo)
    lo = torch.where(ok, lo, zero)
    hi = torch.where(ok, hi, zero)
    half = torch.div(n + 1, 2, rounding_mode="floor")  # rank of the lower median
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cnt = torch.sum((x <= mid[..., None]) & mask, -1)
        ge = cnt >= half
        lo, hi = torch.where(ge, lo, mid), torch.where(ge, mid, hi)
    return torch.where(ok, hi, zero)


def masked_median_hist(x: torch.Tensor, mask: torch.Tensor,
                       bins: int = 256, refine: int = 2, group=None) -> torch.Tensor:
    """Lower median of x where mask along the last axis, by hierarchical
    histogram counting: ``refine`` rounds that each count x against
    ``bins`` edges at once and descend into the median's bin.

    group: a process group whose ranks each hold a part of the values
    (parallel/mesh.py); the range and count, then each round's bin counts,
    are reduced over it, so every rank gets the median of the union,
    exactly: the edges are the same on every rank and the counts are
    integers."""
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    lo = all_reduce(torch.amin(torch.where(mask, x, inf), -1), group, "min")
    hi = all_reduce(torch.amax(torch.where(mask, x, -inf), -1), group, "max")
    n = all_reduce(torch.sum(mask, -1), group)
    ok = n > 0
    zero = torch.zeros_like(lo)
    lo = torch.where(ok, lo, zero)
    hi = torch.where(ok, hi, zero)
    half = torch.div(n + 1, 2, rounding_mode="floor")  # rank of the lower median
    frac = torch.arange(1, bins + 1, dtype=x.dtype, device=x.device) / bins
    for _ in range(refine):
        edges = lo[..., None] + (hi - lo)[..., None] * frac          # (..., B)
        cnt = all_reduce(torch.sum((x[..., None, :] <= edges[..., :, None])
                                   & mask[..., None, :], -1), group)  # (..., B)
        reach = cnt >= half[..., None]
        # first bin whose cumulative count reaches the median rank
        first = torch.argmax(reach.to(torch.int32), -1)
        first = torch.where(torch.any(reach, -1), first,
                            torch.full_like(first, bins - 1))
        width = (hi - lo) / bins
        new_lo = lo + first.to(x.dtype) * width
        hi = lo + (first + 1).to(x.dtype) * width
        lo = new_lo
    return torch.where(ok, hi, zero)


def find_sigma_squared(err_sq: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """MAD-style sigma^2 from masked squared errors (MEstimator.h:109-123),
    with the bisection median the reference uses on its hot paths."""
    med = masked_median_bisect(err_sq, mask)
    n = torch.clamp(torch.sum(mask, -1).to(err_sq.dtype), min=2.0)
    sigma = 1.4826 * (1.0 + 5.0 / (n - 1.0)) * torch.sqrt(med)
    return sigma * sigma


def weight(kind: str, err_sq: torch.Tensor, sigma_sq) -> torch.Tensor:
    """IRLS weight w(e) for the given estimator."""
    sig = torch.clamp(torch.as_tensor(sigma_sq, device=err_sq.device), min=1e-12)
    if kind == TUKEY:
        b_sq = 4.6851 * 4.6851 * sig
        d = 1.0 - err_sq / b_sq
        return torch.where(err_sq <= b_sq, d * d, torch.zeros_like(d))
    if kind == HUBER:
        b_sq = 1.345 * 1.345 * sig
        e = torch.sqrt(torch.clamp(err_sq, min=1e-20))
        return torch.where(err_sq <= b_sq, torch.ones_like(err_sq),
                           torch.sqrt(b_sq) / e)
    raise ValueError(f"unknown estimator {kind!r}")


def objective_score(kind: str, err_sq: torch.Tensor, sigma_sq) -> torch.Tensor:
    """rho(e) objective contribution (MEstimator.h ObjectiveScore)."""
    sig = torch.clamp(torch.as_tensor(sigma_sq, device=err_sq.device), min=1e-12)
    if kind == TUKEY:
        b_sq = 4.6851 * 4.6851 * sig
        d = 1.0 - err_sq / b_sq
        return torch.where(err_sq <= b_sq, (b_sq / 6.0) * (1.0 - d * d * d),
                           (b_sq / 6.0).expand_as(err_sq))
    if kind == HUBER:
        b_sq = 1.345 * 1.345 * sig
        e = torch.sqrt(torch.clamp(err_sq, min=1e-20))
        return torch.where(err_sq <= b_sq, 0.5 * err_sq,
                           torch.sqrt(b_sq) * e - 0.5 * b_sq)
    raise ValueError(f"unknown estimator {kind!r}")
