"""Frozen plain copy of the port's patch search wrapper (ops/search_kernel.py): the plain PyTorch version
only, on every device (the benchmark's reference)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from plainref.config import PATCH_SIZE
from plainref.core.levels import level_n_pos, level_zero_pos
from plainref.ops.atlas import _level0_width_from_atlas, level_xoff_array
from plainref.ops.gather_kernel import gather_windows
from plainref.ops.patch import HALF, MAX_SSD, PACK_CORNER, _SUBPIX_PAD

WSZ = PATCH_SIZE + 1 + 2 * _SUBPIX_PAD  # the subpixel window, 15


def gather_windows3(atlas3, cam_idx, level, y0, x0, G: int):
    """(K,) indices into a (C,H,AW) atlas -> ((K,G,G) f32, (K,) ok).
    y0/x0 are level-local coords; the level x-offset is added here."""
    C, H, AW = atlas3.shape
    xoffs = level_xoff_array(_level0_width_from_atlas(AW), atlas3.device)
    ax0 = x0 + xoffs[level]
    ok = (y0 >= 0) & (ax0 >= 0) & (y0 + G <= H) & (ax0 + G <= AW)
    rows = cam_idx * H + torch.clamp(y0, 0, H - G)
    cols = torch.clamp(ax0, 0, AW - G)
    return gather_windows(atlas3.reshape(C * H, AW), rows, cols, G), ok


def _box8(a, S: int):
    """(K,G,G) -> (K,S,S) 8x8 window sums (columns first, then rows)."""
    rows = sum(a[:, :, px : px + S] for px in range(PATCH_SIZE))
    return sum(rows[:, py : py + S, :] for py in range(PATCH_SIZE))


def search_patches_reference(packed_atlas3, level_hw, cam_idx, search_level,
                             templates, pred_pos_l0, range_l0: int, max_range_l0,
                             exhaustive=False, max_ssd: float = MAX_SSD, box=None):
    """Plain version: the (G2,G2) region gather (the window kernel on the
    card), the eager ZMSSD search and the window cut.  Returns (found (K,),
    pos_l0 (K,2), best_ssd (K,), aux) with aux = dict(win (K,15,15),
    region_ok, by, bx); box, if given, receives sum_p and sum_p2."""
    K = cam_idx.shape[0]
    lvl_f = search_level.to(torch.float32)
    scale = torch.exp2(lvl_f)
    pos_lev = level_n_pos(pred_pos_l0, lvl_f[:, None])
    r_lev = torch.ceil(max_range_l0 / scale)

    R = range_l0
    S = 2 * R + 1
    G = S + PATCH_SIZE
    P = _SUBPIX_PAD
    G2 = G + 2 * P  # padded so the subpixel window lies inside the region
    cxi = torch.round(pos_lev[:, 0]).to(torch.int64)  # half to even
    cyi = torch.round(pos_lev[:, 1]).to(torch.int64)
    y0 = cyi - R - HALF
    x0 = cxi - R - HALF
    region_raw, region_ok = gather_windows3(
        packed_atlas3, cam_idx, search_level, y0 - P, x0 - P, G2
    )
    flag2 = region_raw >= PACK_CORNER / 2
    region2 = region_raw - PACK_CORNER * flag2.to(region_raw.dtype)
    region = region2[:, P : P + G, P : P + G]
    is_corner = flag2[:, P + HALF : P + HALF + S, P + HALF : P + HALF + S]

    n = PATCH_SIZE * PATCH_SIZE
    t = templates                                                # (K,8,8)
    sum_t = torch.sum(t, (1, 2))[:, None, None]
    sum_t2 = torch.sum(t * t, (1, 2))[:, None, None]
    sum_p = _box8(region, S)
    sum_p2 = _box8(region * region, S)
    if box is not None:
        box[0].copy_(sum_p)
        box[1].copy_(sum_p2)
    # cross-correlation as one depthwise convolution (K groups), full f32
    cross = F.conv2d(region[None], t[:, None], groups=K)[0][:, :S, :S]
    scores = sum_p2 - 2.0 * cross + sum_t2 - (sum_p - sum_t) ** 2 / n

    hs, ws = level_hw
    h_l = hs[search_level].to(torch.float32)[:, None, None]
    w_l = ws[search_level].to(torch.float32)[:, None, None]
    d = torch.arange(S, dtype=torch.float32, device=t.device) - R
    yy = cyi.to(torch.float32)[:, None, None] + d[None, :, None]  # (K,S,S)
    xx = cxi.to(torch.float32)[:, None, None] + d[None, None, :]
    dist_ok = (
        (yy - pos_lev[:, 1, None, None]) ** 2
        + (xx - pos_lev[:, 0, None, None]) ** 2
    ) <= (r_lev * r_lev + 1e-6)[:, None, None]
    in_bounds = ((xx >= HALF) & (yy >= HALF)
                 & (xx < w_l - HALF) & (yy < h_l - HALF))
    exhaustive = torch.as_tensor(exhaustive, device=t.device)
    if exhaustive.ndim:
        exhaustive = exhaustive[:, None, None]
    valid = dist_ok & in_bounds & (is_corner | exhaustive)
    valid = valid & region_ok[:, None, None]
    scores = torch.where(valid, scores, torch.full_like(scores, float("inf")))

    flat = scores.reshape(K, S * S)
    best_ssd, best = torch.min(flat, 1)       # first index of the minimum
    by = torch.div(best, S, rounding_mode="floor")
    bx = best % S
    found = best_ssd < max_ssd
    pos_lev_best = torch.stack(
        [(cxi + bx - R).to(torch.float32), (cyi + by - R).to(torch.float32)], -1
    )
    pos_l0 = level_zero_pos(pos_lev_best, lvl_f[:, None])
    ar = torch.arange(WSZ, device=region2.device)
    k = torch.arange(K, device=region2.device)[:, None, None]
    win = region2[k, (by[:, None] + ar)[:, :, None], (bx[:, None] + ar)[:, None, :]]
    aux = dict(win=win, region_ok=region_ok, by=by, bx=bx)
    return found, pos_l0, best_ssd, aux


def search_patches(packed_atlas3, level_hw, cam_idx, search_level, templates,
                   pred_pos_l0, range_l0: int, max_range_l0,
                   exhaustive=False, max_ssd: float = MAX_SSD, box=None):
    return search_patches_reference(packed_atlas3, level_hw, cam_idx, search_level,
                                    templates, pred_pos_l0, range_l0, max_range_l0,
                                    exhaustive, max_ssd, box)
