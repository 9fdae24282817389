"""Robust M-estimators (port of the tracking subset of
mcptam_tpu/core/mest.py, ref include/mcptam/MEstimator.h)."""

from __future__ import annotations

import torch

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
