"""MiniPatch: unwarped 9x9 SSD patch search and the temporal candidate
stability filter (port of mcptam_tpu/ops/minipatch.py, ref
src/MiniPatch.cc:61-127 and MakeKeyFrame_Rest, src/KeyFrame.cc:456-529).

Each candidate corner is tracked from the current frame into the previous
one and back; it survives when it returns within 2 px.  Every function is
batched over a leading candidate axis, and every 9x9 template and every
29x29 search region is read by ``gather_unaligned`` (K8, the hand-written
kernel ``csrc/gather_unaligned.cu`` on the card).  A window that does not
lie inside its image carries ``ok`` False and is masked out, exactly as the
JAX package masks its clamped ``dynamic_slice`` windows, so wherever
``ok`` holds the two packages read the same pixels.
"""

from __future__ import annotations

import dataclasses

import torch

from mcptam_tpu_torch.config import LEVELS
from mcptam_tpu_torch.ops.atlas import _level0_width_from_atlas, atlas_xoff
from mcptam_tpu_torch.ops.gather_unaligned_kernel import gather_unaligned

MINI_HALF = 4                  # 9x9 patch (ref MiniPatch.h mnHalfPatchSize)
MINI_SIZE = 2 * MINI_HALF + 1
MAX_SSD = 9999.0               # ref src/MiniPatch.cc:124-127
STABILITY_RADIUS = 10          # search radius (level px)
RETURN_TOL = 2.0               # round-trip acceptance (ref KeyFrame.cc:456-529)


@dataclasses.dataclass
class _Images:
    """Level images inside one 2-D plane: candidate k's image starts at
    (row0[k], col0[k]) of ``plane`` and is h[k] x w[k] (ints or (K,))."""
    plane: torch.Tensor
    row0: object
    col0: object
    h: object
    w: object


def _single(img: torch.Tensor) -> _Images:
    return _Images(img.contiguous(), 0, 0, img.shape[0], img.shape[1])


def _window(im: _Images, y0, x0, size: int):
    """(K,size,size) windows at level coords (y0, x0) and whether each lies
    inside its image."""
    ok = (y0 >= 0) & (x0 >= 0) & (y0 + size <= im.h) & (x0 + size <= im.w)
    return gather_unaligned(im.plane, y0 + im.row0, x0 + im.col0, size), ok


def _round_xy(xy: torch.Tensor):
    xy = torch.round(xy).to(torch.int64)
    return xy[:, 0], xy[:, 1]


def _template(im: _Images, xy: torch.Tensor):
    xi, yi = _round_xy(xy)
    return _window(im, yi - MINI_HALF, xi - MINI_HALF, MINI_SIZE)


def _search(im: _Images, template: torch.Tensor, pred_xy: torch.Tensor,
            radius: int, max_ssd: float):
    S = 2 * radius + 1
    cxi, cyi = _round_xy(pred_xy)
    region, rok = _window(im, cyi - radius - MINI_HALF, cxi - radius - MINI_HALF,
                          S + MINI_SIZE - 1)
    # accumulate in the JAX package's order (py-major), so the sums are the
    # same f32 values
    ssd = None
    for py in range(MINI_SIZE):
        for px in range(MINI_SIZE):
            term = (region[:, py:py + S, px:px + S]
                    - template[:, py, px, None, None]) ** 2
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


def _stability(prev: _Images, cur: _Images, cand_xy, cand_valid,
               radius: int, tol: float):
    xy = cand_xy.to(torch.float32)
    t_cur, t_ok = _template(cur, xy)
    f1, xy_prev, _ = _search(prev, t_cur, xy, radius, MAX_SSD)
    t_prev, tp_ok = _template(prev, xy_prev)
    f2, xy_back, _ = _search(cur, t_prev, xy_prev, radius, MAX_SSD)
    err = torch.sqrt(torch.sum((xy_back - xy) ** 2, -1))
    return cand_valid & t_ok & tp_ok & f1 & f2 & (err <= tol)


def mini_template(img: torch.Tensor, xy: torch.Tensor):
    """(K,9,9) templates of an (h,w) image centred at the rounded (K,2)
    xy = (x, y), and whether each lies inside the image."""
    return _template(_single(img), xy)


def mini_search(img: torch.Tensor, template: torch.Tensor, pred_xy: torch.Tensor,
                radius: int = STABILITY_RADIUS, max_ssd: float = MAX_SSD):
    """Plain-SSD search of (K,9,9) templates around (K,2) predictions over
    every offset within ``radius`` (ref FindPatch, src/MiniPatch.cc:61-113).
    Returns (found (K,), xy (K,2) f32, ssd (K,))."""
    return _search(_single(img), template, pred_xy, radius, max_ssd)


def stability_filter(prev_img: torch.Tensor, cur_img: torch.Tensor,
                     cand_xy: torch.Tensor, cand_valid: torch.Tensor,
                     radius: int = STABILITY_RADIUS, tol: float = RETURN_TOL):
    """Round-trip stability of (K,2) level-coordinate candidates between two
    (h,w) images of one level: track cur -> prev -> cur, keep those that
    return within ``tol`` px.  Returns the pruned validity mask (K,)."""
    return _stability(_single(prev_img), _single(cur_img), cand_xy, cand_valid,
                      radius, tol)


def filter_frame_candidates(prev_feats, feats):
    """The stability filter on every camera and level of a FrameFeatures
    pair (previous frame, current frame), all candidates in one batch read
    straight from the (C*H, AW) atlas planes.  Returns feats with the pruned
    ``cand_valid``."""
    C, H, AW = feats.atlas.shape
    W0 = _level0_width_from_atlas(AW)
    xoffs = atlas_xoff(W0)
    dev = feats.atlas.device
    xy, valid, row0, col0, hs, ws, sizes = [], [], [], [], [], [], []
    for l in range(LEVELS):
        K = feats.cand_valid[l].shape[1]
        xy.append(feats.cand_xy[l].reshape(C * K, 2))
        valid.append(feats.cand_valid[l].reshape(C * K))
        row0.append(torch.arange(C, device=dev).repeat_interleave(K) * H)
        for lst, v in ((col0, xoffs[l]), (hs, H >> l), (ws, W0 >> l)):
            lst.append(torch.full((C * K,), v, dtype=torch.int64, device=dev))
        sizes.append(C * K)
    row0, col0, hs, ws = (torch.cat(x) for x in (row0, col0, hs, ws))
    prev = _Images(prev_feats.atlas.reshape(C * H, AW).contiguous(), row0, col0, hs, ws)
    cur = _Images(feats.atlas.reshape(C * H, AW).contiguous(), row0, col0, hs, ws)
    kept = _stability(prev, cur, torch.cat(xy), torch.cat(valid),
                      STABILITY_RADIUS, RETURN_TOL)
    new_valid = tuple(v.reshape(C, -1) for v in torch.split(kept, sizes))
    return dataclasses.replace(feats, cand_valid=new_valid)
