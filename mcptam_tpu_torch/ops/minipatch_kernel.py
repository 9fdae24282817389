"""MiniPatch's round-trip stability search over K candidates (port of
mcptam_tpu/ops/minipatch.py::stability_filter, with its windows read
under K8's contract, scripts/profile_gather.py::gather_unaligned).

Candidate k lies in an image of h x w pixels that starts at (row0, col0)
of a 2-D f32 plane; the previous and the current frame's planes share
that layout.  Its 9x9 template is taken from the current frame at the
rounded candidate, searched for over every offset within radius 10 in
the previous frame (plain SSD, first-index argmin), the previous frame's
template at the position found is searched for back in the current
frame, and the candidate is kept when it returns within ``tol`` px.

A CUDA tensor launches the hand-written kernel ``csrc/minipatch.cu``, one
launch for every candidate; a CPU tensor takes ``stability_reference``,
which reads its windows through K8's plain gather and sums the SSDs as
eager operators.  Both return a ``RoundTrip``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from mcptam_tpu_torch import backend
from mcptam_tpu_torch.ops.atlas import _level0_width_from_atlas, atlas_xoff
from mcptam_tpu_torch.ops.gather_unaligned_kernel import gather_unaligned_reference

MINI_HALF = 4                  # 9x9 patch (ref MiniPatch.h mnHalfPatchSize)
MINI_SIZE = 2 * MINI_HALF + 1
MAX_SSD = 9999.0               # ref src/MiniPatch.cc:124-127
STABILITY_RADIUS = 10          # search radius (level px); the kernel's only one
RETURN_TOL = 2.0               # round-trip acceptance (ref KeyFrame.cc:456-529)


class RoundTrip(NamedTuple):
    """The round trip of K candidates.  ``kept`` (K,) is the pruned
    validity mask; row 0 of the rest is the search into the previous
    frame, row 1 the search back.  ``ran`` (2,K) says which searches the
    result needs: the first for a valid candidate, the return search where
    also the template, the first search and the return template held.  The
    kernel skips the others and leaves found False, xy 0 and ssd NaN there;
    the plain version computes every search."""
    kept: torch.Tensor    # (K,) bool
    ran: torch.Tensor     # (2,K) bool
    found: torch.Tensor   # (2,K) bool
    xy: torch.Tensor      # (2,K,2) f32, the best position (x, y)
    ssd: torch.Tensor     # (2,K) f32, the best SSD (inf when every offset was masked)


@dataclasses.dataclass
class Images:
    """Level images inside one 2-D plane: candidate k's image starts at
    (row0[k], col0[k]) of ``plane`` and is h[k] x w[k] (ints or (K,))."""
    plane: torch.Tensor
    row0: object
    col0: object
    h: object
    w: object


def window(im: Images, y0, x0, size: int, gather):
    """(K,size,size) windows at level coords (y0, x0), read by ``gather``
    under K8's contract, and whether each lies inside its image."""
    ok = (y0 >= 0) & (x0 >= 0) & (y0 + size <= im.h) & (x0 + size <= im.w)
    return gather(im.plane, y0 + im.row0, x0 + im.col0, size), ok


def _round_xy(xy: torch.Tensor):
    xy = torch.round(xy).to(torch.int64)          # half to even
    return xy[:, 0], xy[:, 1]


def template(im: Images, xy: torch.Tensor, gather):
    """(K,9,9) templates at the rounded (K,2) xy and their ``ok`` flags."""
    xi, yi = _round_xy(xy)
    return window(im, yi - MINI_HALF, xi - MINI_HALF, MINI_SIZE, gather)


def search(im: Images, tmpl: torch.Tensor, pred_xy: torch.Tensor, radius: int,
           max_ssd: float, gather):
    """Plain-SSD search of (K,9,9) templates over every offset within
    ``radius`` of the rounded (K,2) predictions.  Returns (found (K,),
    xy (K,2) f32, ssd (K,))."""
    S = 2 * radius + 1
    cxi, cyi = _round_xy(pred_xy)
    region, rok = window(im, cyi - radius - MINI_HALF, cxi - radius - MINI_HALF,
                         S + MINI_SIZE - 1, gather)
    # accumulate in the JAX package's order (py-major), so the sums are the
    # same f32 values
    ssd = None
    for py in range(MINI_SIZE):
        for px in range(MINI_SIZE):
            term = (region[:, py:py + S, px:px + S]
                    - tmpl[:, py, px, None, None]) ** 2
            ssd = term if ssd is None else ssd + term
    d = torch.arange(S, device=pred_xy.device) - radius
    h = torch.as_tensor(im.h, device=pred_xy.device).reshape(-1, 1)
    w = torch.as_tensor(im.w, device=pred_xy.device).reshape(-1, 1)
    yy = cyi[:, None] + d
    xx = cxi[:, None] + d
    in_b = (((yy >= MINI_HALF) & (yy < h - MINI_HALF))[:, :, None]
            & ((xx >= MINI_HALF) & (xx < w - MINI_HALF))[:, None, :])
    ssd = torch.where(in_b & rok[:, None, None], ssd,
                      torch.full_like(ssd, float("inf"))).reshape(ssd.shape[0], -1)
    best = torch.argmin(ssd, -1)                   # first minimum, as jnp.argmin
    best_ssd = torch.gather(ssd, 1, best[:, None])[:, 0]
    by, bx = torch.div(best, S, rounding_mode="floor"), best % S
    xy = torch.stack([(cxi + bx - radius).to(torch.float32),
                      (cyi + by - radius).to(torch.float32)], -1)
    return best_ssd < max_ssd, xy, best_ssd


@functools.lru_cache(maxsize=16)
def level_descriptors(C: int, H: int, AW: int, counts: tuple, device) -> torch.Tensor:
    """(K,4) int32 (row0, col0, h, w) of the candidates of a (C*H, AW)
    atlas plane: levels in order, within a level camera-major, counts[l]
    candidates a camera.  Built once per shape and device; callers must
    not modify it."""
    W0 = _level0_width_from_atlas(AW)
    xoffs = atlas_xoff(W0)
    rows = []
    for l, K in enumerate(counts):
        d = np.empty((C, K, 4), np.int32)
        d[..., 0] = (np.arange(C) * H)[:, None]
        d[..., 1:] = (xoffs[l], H >> l, W0 >> l)
        rows.append(d.reshape(C * K, 4))
    return torch.as_tensor(np.concatenate(rows)).to(device)


def single_descriptors(h: int, w: int, K: int, device) -> torch.Tensor:
    """(K,4) int32 descriptors of K candidates in one (h,w) image."""
    return torch.tensor([[0, 0, h, w]], dtype=torch.int32, device=device).expand(K, 4).contiguous()


def stability_reference(prev_plane: torch.Tensor, cur_plane: torch.Tensor,
                        desc: torch.Tensor, cand_xy: torch.Tensor, cand_valid: torch.Tensor,
                        radius: int = STABILITY_RADIUS, tol: float = RETURN_TOL,
                        gather=gather_unaligned_reference) -> RoundTrip:
    """Plain version: the round trip as eager operators, every window read
    by ``gather`` (K8's plain gather; K8's kernel, ``gather_unaligned``,
    gives the path this kernel replaced)."""
    d = desc.to(torch.int64)
    prev = Images(prev_plane, d[:, 0], d[:, 1], d[:, 2], d[:, 3])
    cur = Images(cur_plane, d[:, 0], d[:, 1], d[:, 2], d[:, 3])
    xy = cand_xy.to(torch.float32)
    t_cur, t_ok = template(cur, xy, gather)
    f1, xy_prev, ssd1 = search(prev, t_cur, xy, radius, MAX_SSD, gather)
    t_prev, tp_ok = template(prev, xy_prev, gather)
    f2, xy_back, ssd2 = search(cur, t_prev, xy_prev, radius, MAX_SSD, gather)
    err = torch.sqrt(torch.sum((xy_back - xy) ** 2, -1))
    go = cand_valid & t_ok & f1 & tp_ok
    return RoundTrip(kept=go & f2 & (err <= tol), ran=torch.stack([cand_valid, go]),
                     found=torch.stack([f1, f2]), xy=torch.stack([xy_prev, xy_back]),
                     ssd=torch.stack([ssd1, ssd2]))


def stability_search(prev_plane: torch.Tensor, cur_plane: torch.Tensor, desc: torch.Tensor,
                     cand_xy: torch.Tensor, cand_valid: torch.Tensor,
                     radius: int = STABILITY_RADIUS, tol: float = RETURN_TOL) -> RoundTrip:
    """The round trip of K candidates between two (HH,AW) f32 planes of
    one layout: desc (K,4) int32 (row0, col0, h, w), cand_xy (K,2) level
    coords (x, y), cand_valid (K,) bool."""
    K = cand_xy.shape[0]
    if (prev_plane.ndim != 2 or prev_plane.shape != cur_plane.shape
            or prev_plane.dtype != torch.float32 or cur_plane.dtype != torch.float32):
        raise ValueError("stability_search takes two float32 planes of one shape, got "
                         f"{prev_plane.dtype} {tuple(prev_plane.shape)} and "
                         f"{cur_plane.dtype} {tuple(cur_plane.shape)}")
    if (desc.shape != (K, 4) or desc.dtype != torch.int32 or cand_xy.shape != (K, 2)
            or cand_valid.shape != (K,) or cand_valid.dtype != torch.bool
            or cand_xy.dtype.is_complex or cand_xy.dtype == torch.bool):
        raise ValueError(f"stability_search: bad candidates: desc {desc.dtype} "
                         f"{tuple(desc.shape)}, xy {cand_xy.dtype} {tuple(cand_xy.shape)}, "
                         f"valid {cand_valid.dtype} {tuple(cand_valid.shape)}")
    dev = prev_plane.device
    if any(x.device != dev for x in (cur_plane, desc, cand_xy, cand_valid)):
        raise ValueError("stability_search: every tensor must lie on the planes' device")
    if dev.type == "cpu":
        return stability_reference(prev_plane, cur_plane, desc, cand_xy, cand_valid,
                                   radius, tol)
    if dev.type != "cuda":
        raise ValueError(f"stability_search: unsupported device {dev}")
    if radius != STABILITY_RADIUS:
        raise ValueError(f"stability_search: the kernel searches radius {STABILITY_RADIUS}, "
                         f"not {radius}")
    prev_plane, cur_plane = prev_plane.contiguous(), cur_plane.contiguous()
    desc = desc.contiguous()
    if desc.data_ptr() % 16:              # the kernel reads a row as one int4
        desc = desc.clone()
    xy = cand_xy.to(torch.float32).contiguous()
    if xy.data_ptr() % 8:                 # and a candidate as one float2
        xy = xy.clone()
    valid = cand_valid.contiguous()
    out = RoundTrip(kept=torch.empty(K, dtype=torch.bool, device=dev),
                    ran=torch.empty((2, K), dtype=torch.bool, device=dev),
                    found=torch.empty((2, K), dtype=torch.bool, device=dev),
                    xy=torch.empty((2, K, 2), dtype=torch.float32, device=dev),
                    ssd=torch.empty((2, K), dtype=torch.float32, device=dev))
    if K == 0:
        return out
    from mcptam_tpu_torch.csrc._build import check, load

    HH, AW = prev_plane.shape
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = load().mcptam_stability_search(
        prev_plane.data_ptr(), cur_plane.data_ptr(), desc.data_ptr(), xy.data_ptr(),
        valid.data_ptr(), K, HH, AW, float(MAX_SSD), float(tol), out.kept.data_ptr(),
        out.ran.data_ptr(), out.found.data_ptr(), out.xy.data_ptr(), out.ssd.data_ptr(),
        stream)
    check(err, "stability_search")
    backend.count_launch("stability_filter")
    return out
