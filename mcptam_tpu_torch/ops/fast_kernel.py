"""FAST-10 front-end: score + 3x3 nonmax + threshold histograms in one pass
(port of mcptam_tpu/ops/fast_pallas.py::fast_frontend).

CUDA tensors launch the hand-written kernel ``csrc/fast.cu``, once for all
the pyramid levels of a frame (``fast_frontend_levels``); CPU tensors take
``fast_frontend_reference``, the plain PyTorch version with identical
outputs.  There is no other route.
"""

from __future__ import annotations

import ctypes

import torch

from mcptam_tpu_torch import backend
from mcptam_tpu_torch.ops.fast import fast_score_image, nonmax_3x3

NBINS = 64  # freq[t] for t in [0, 64): covers the 5..60 adaptive range
MAX_LEVELS = 8  # levels one launch takes (csrc/fast.cu)
# int32 scratch per (level, camera): bin counts of score and nm (65 each),
# the last-block ticket and a pad.  The kernel leaves it zero.
SCRATCH_INTS = 2 * (NBINS + 1) + 2

# (device index, stream) -> the zeroed scratch the kernel reuses
_SCRATCH: dict = {}


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


def _scratch(device: torch.device, stream: int, n_ints: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < n_ints:
        buf = torch.zeros(n_ints, dtype=torch.int32, device=device)
        _SCRATCH[key] = buf
    return buf


def fast_frontend_levels(levels, rows=None) -> list:
    """Pyramid levels, each (C,H_l,W_l) f32 -> per level (score (C,H_l,W_l),
    nm (C,H_l,W_l), freq (C,NBINS), freq_nm (C,NBINS)).

    score/nm: FAST-10 max-threshold score and its strict 3x3 nonmax
    (earlier raster pixel wins ties); freq[c, t] = #(score > t - 1e-6) and
    freq_nm the same over nm, over the in-image pixels of the rows
    [y0, y1) that ``rows`` gives each level (default: every row; a row
    slab of a sharded image counts its interior, parallel/mesh.py).  On
    the card one launch computes every level; the outputs are views of
    one buffer."""
    levels = list(levels)
    rows = [None] * len(levels) if rows is None else list(rows)
    if len(rows) != len(levels):
        raise ValueError(f"fast_frontend_levels: {len(rows)} row ranges for "
                         f"{len(levels)} levels")
    ranges = [_row_range(r, p.shape[-2]) for r, p in zip(rows, levels)]
    if all(p.device.type == "cpu" for p in levels):
        return [fast_frontend_reference(p, r) for p, r in zip(levels, ranges)]
    dev = levels[0].device
    if dev.type != "cuda" or any(p.device != dev for p in levels):
        raise ValueError("fast_frontend_levels: every level on one CUDA device, got "
                         f"{[str(p.device) for p in levels]}")
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"fast_frontend_levels takes 1..{MAX_LEVELS} levels, "
                         f"got {len(levels)}")
    C = levels[0].shape[0]
    for p in levels:
        if (p.dtype != torch.float32 or p.ndim != 3 or p.shape[0] != C
                or not p.is_contiguous() or p.numel() == 0):
            raise ValueError("fast_frontend_levels takes contiguous non-empty (C,H,W) "
                             f"float32 levels of one C, got {p.dtype} {tuple(p.shape)}")
    from mcptam_tpu_torch.csrc._build import check, load

    lib = load()
    L = len(levels)
    n_px = sum(p.numel() for p in levels)
    buf = torch.empty(2 * n_px + 2 * L * C * NBINS, dtype=torch.float32, device=dev)
    o, outs, ptrs, dims = 0, [], [], []
    for p in levels:
        score = buf[o:o + p.numel()].view(p.shape)
        nm = buf[o + p.numel():o + 2 * p.numel()].view(p.shape)
        o += 2 * p.numel()
        outs.append([score, nm])
    for out in outs:
        for _ in range(2):                    # freq, freq_nm
            out.append(buf[o:o + C * NBINS].view(C, NBINS))
            o += C * NBINS
    for p, out, (y0, y1) in zip(levels, outs, ranges):
        ptrs += [p.data_ptr()] + [t.data_ptr() for t in out]
        dims += [p.shape[1], p.shape[2], y0, y1]
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = _scratch(dev, stream, L * C * SCRATCH_INTS)
    c_ptrs = (ctypes.c_longlong * len(ptrs))(*ptrs)
    c_dims = (ctypes.c_int * len(dims))(*dims)
    err = lib.mcptam_fast_frontend_levels(ctypes.addressof(c_ptrs), ctypes.addressof(c_dims),
                                          L, C, scratch.data_ptr(), stream)
    check(err, "fast_frontend_levels")
    backend.count_launch("fast_frontend")
    return [tuple(out) for out in outs]


def fast_frontend(img: torch.Tensor):
    """One level: (C,H,W) f32 image -> (score, nm, freq, freq_nm), as
    ``fast_frontend_levels`` computes them (one launch on the card)."""
    return fast_frontend_levels([img])[0]
