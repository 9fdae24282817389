"""Batched patch search: the tracker's hot path (port of
mcptam_tpu/ops/batch_patch.py, ref src/PatchFinder.cc).

Stages, each over K (camera, point) pairs at once:
  * warped 8x8 template by bilinear (hat-weight) sampling of the point's
    stored source window (MakeTemplateCoarseCont, :135-182);
  * dense ZMSSD at every offset of a (G,G) search region from 8-tap box
    sums and a depthwise cross-correlation in full f32 (FindPatchCoarse +
    the SSE ZMSSD kernel, :229-355, :491-658), first-index argmin;
  * inverse-composition subpixel refinement resampled inside the already
    gathered region (IterateSubPixToConvergence, :396-470).

The window gathers go through ``ops/gather_kernel.gather_windows`` (the
CUDA kernel on the card).  Unlike the reference, tensors keep the pair
axis first: the reference's pair-axis-last layout served TPU vector lanes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mcptam_tpu_torch.config import PATCH_SIZE
from mcptam_tpu_torch.core.levels import level_n_pos, level_zero_pos
from mcptam_tpu_torch.core.linalg import inv3
from mcptam_tpu_torch.ops.atlas import level_xoff_array, _level0_width_from_atlas
from mcptam_tpu_torch.ops.gather_kernel import gather_windows
from mcptam_tpu_torch.ops.patch import HALF, MAX_SSD, PACK_CORNER, _SUBPIX_PAD

_SRC_HALF = 12  # template source window half-size


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


def gather_windows4(atlas4, mkf_idx, cam_idx, level, y0, x0, G: int):
    """(K,) indices into the (M,C,H,AW) keyframe store."""
    M, C, H, AW = atlas4.shape
    xoffs = level_xoff_array(_level0_width_from_atlas(AW), atlas4.device)
    ax0 = x0 + xoffs[level]
    ok = (y0 >= 0) & (ax0 >= 0) & (y0 + G <= H) & (ax0 + G <= AW)
    rows = (mkf_idx * C + cam_idx) * H + torch.clamp(y0, 0, H - G)
    cols = torch.clamp(ax0, 0, AW - G)
    return gather_windows(atlas4.reshape(M * C * H, AW), rows, cols, G), ok


def _hat(x, n: int):
    """(...,) coords -> (..., n) triangle (bilinear) weights over 0..n-1."""
    anchors = torch.arange(n, dtype=torch.float32, device=x.device)
    return torch.clamp(1.0 - torch.abs(x[..., None] - anchors), min=0.0)


def make_warped_templates(src_win, win_ok, level_hw, src_level,
                          src_center_xy, warp_inv, search_level):
    """(K,...) inputs -> (templates (K,8,8), ok (K,)).

    src_win: (K,26,26) stored source windows; sampling matrix
    m2 = inv(warp_inv) * 2^search_level (source-level px per template px)."""
    K = src_level.shape[0]
    det = (warp_inv[:, 0, 0] * warp_inv[:, 1, 1]
           - warp_inv[:, 0, 1] * warp_inv[:, 1, 0])
    det_safe = torch.where(torch.abs(det) < 1e-12, torch.ones_like(det), det)
    inv = torch.stack([
        torch.stack([warp_inv[:, 1, 1], -warp_inv[:, 0, 1]], -1),
        torch.stack([-warp_inv[:, 1, 0], warp_inv[:, 0, 0]], -1),
    ], 1) / det_safe[:, None, None]
    m2 = inv * torch.exp2(search_level.to(torch.float32))[:, None, None]

    cx = src_center_xy[:, 0]
    cy = src_center_xy[:, 1]
    cxi = torch.floor(cx)
    cyi = torch.floor(cy)
    S = 2 * _SRC_HALF + 2
    win = src_win.to(torch.float32)

    off = torch.arange(PATCH_SIZE, dtype=torch.float32, device=win.device) - HALF
    oy = off[:, None]
    ox = off[None, :]
    sx = (m2[:, 0, 0, None, None] * ox + m2[:, 0, 1, None, None] * oy
          + (cx - cxi)[:, None, None] + _SRC_HALF)              # (K,8,8)
    sy = (m2[:, 1, 0, None, None] * ox + m2[:, 1, 1, None, None] * oy
          + (cy - cyi)[:, None, None] + _SRC_HALF)

    inside = (sx >= 0) & (sx <= S - 2) & (sy >= 0) & (sy <= S - 2)
    sxc = torch.clamp(sx, 0.0, S - 1.0)
    syc = torch.clamp(sy, 0.0, S - 1.0)
    # separable hat contraction: t[k,i,j] = hy[k,ij,:] @ win[k] @ hx[k,ij,:]
    hy = _hat(syc.reshape(K, -1), S)                             # (K,64,S)
    hx = _hat(sxc.reshape(K, -1), S)
    z = torch.bmm(hy, win)                                       # (K,64,S)
    tmpl = torch.sum(z * hx, -1).reshape(K, PATCH_SIZE, PATCH_SIZE)

    hs, ws = level_hw
    h_l = hs[src_level].to(torch.float32)[:, None, None]
    w_l = ws[src_level].to(torch.float32)[:, None, None]
    lx = sx - _SRC_HALF + cxi[:, None, None]
    ly = sy - _SRC_HALF + cyi[:, None, None]
    in_level = (lx >= 0) & (lx <= w_l - 2) & (ly >= 0) & (ly <= h_l - 2)
    ok = (torch.all((inside & in_level).reshape(K, -1), -1) & win_ok
          & (torch.abs(det) > 1e-12))
    return tmpl, ok


def _box8(a, S: int):
    """(K,G,G) -> (K,S,S) 8x8 window sums (columns first, then rows)."""
    rows = sum(a[:, :, px : px + S] for px in range(PATCH_SIZE))
    return sum(rows[:, py : py + S, :] for py in range(PATCH_SIZE))


def find_patches(packed_atlas3, level_hw, cam_idx, search_level, templates,
                 pred_pos_l0, range_l0: int, max_range_l0,
                 exhaustive=False, max_ssd: float = MAX_SSD):
    """Batched FindPatchCoarse over K pairs.

    packed_atlas3: pack_corner_atlas(atlas, corner_atlas) (C,H,AW);
    max_range_l0: scalar tensor radius (<= range_l0) actually enforced.
    Returns (found (K,), pos_l0 (K,2), best_ssd (K,), aux) where aux
    carries the gathered region and best offsets for subpix_refine_region."""
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
    aux = dict(region2=region2, region_ok=region_ok, by=by, bx=bx, S=S)
    return found, pos_l0, best_ssd, aux


def subpix_refine_region(aux, level_hw, search_level, templates, pos_l0,
                         n_its: int = 10, conv_limit: float = 0.03):
    """Subpixel refinement resampling from the already-gathered search
    region: the (15,15) iteration window is cut out at the best offset."""
    region2 = aux["region2"]                       # (K,G2,G2) pixel values
    by, bx = aux["by"], aux["bx"]
    WSZ = PATCH_SIZE + 1 + 2 * _SUBPIX_PAD
    ar = torch.arange(WSZ, device=region2.device)
    ry = (by[:, None] + ar)[:, :, None]
    rx = (bx[:, None] + ar)[:, None, :]
    k = torch.arange(region2.shape[0], device=region2.device)[:, None, None]
    win = region2[k, ry, rx]                                     # (K,WSZ,WSZ)
    return _subpix_iterate(win, aux["region_ok"], level_hw, search_level,
                           templates, pos_l0, n_its, conv_limit)


def _subpix_iterate(win, win_ok, level_hw, search_level, templates, pos_l0,
                    n_its: int, conv_limit: float):
    """Inverse-composition loop over a (K,WSZ,WSZ) window stack."""
    K = templates.shape[0]
    lvl_f = search_level.to(torch.float32)
    scale = torch.exp2(lvl_f)
    hs, ws = level_hw
    h_l = hs[search_level].to(torch.float32)
    w_l = ws[search_level].to(torch.float32)

    # template gradients + 3x3 inverse Hessians
    gx = 0.5 * (templates[:, 1:-1, 2:] - templates[:, 1:-1, :-2])  # (K,6,6)
    gy = 0.5 * (templates[:, 2:, 1:-1] - templates[:, :-2, 1:-1])
    J = torch.stack([gx, gy, torch.ones_like(gx)], -1).reshape(K, -1, 3)
    eye3 = torch.eye(3, dtype=J.dtype, device=J.device)
    Hinv = inv3(J.transpose(1, 2) @ J + 1e-6 * eye3)

    P = _SUBPIX_PAD
    WSZ = PATCH_SIZE + 1 + 2 * P
    base0 = level_n_pos(pos_l0, lvl_f[:, None]) - HALF
    byi0 = torch.floor(base0[:, 1]) - P
    bxi0 = torch.floor(base0[:, 0]) - P

    SP = PATCH_SIZE
    sp_ids = torch.arange(SP, dtype=torch.float32, device=win.device)
    w_ids = torch.arange(WSZ, dtype=torch.float32, device=win.device)
    tmpl_in = templates[:, 1:-1, 1:-1]

    pos = pos_l0.to(torch.float32)
    mean_diff = torch.zeros(K, device=win.device)
    done = torch.zeros(K, dtype=torch.bool, device=win.device)
    ok = win_ok
    for _ in range(n_its):
        center = level_n_pos(pos, lvl_f[:, None])
        base = center - HALF
        wy = base[:, 1] - byi0
        wx = base[:, 0] - bxi0
        off_edge = (
            (center[:, 0] < HALF + 1) | (center[:, 1] < HALF + 1)
            | (center[:, 0] > w_l - HALF - 2) | (center[:, 1] > h_l - HALF - 2)
            | (wy < 0) | (wx < 0)
            | (wy > WSZ - PATCH_SIZE - 2) | (wx > WSZ - PATCH_SIZE - 2)
        )
        # hat weights of template row i over window row r (bilinear)
        hy2 = torch.clamp(1.0 - torch.abs(
            wy[:, None, None] + sp_ids[None, :, None] - w_ids[None, None, :]
        ), min=0.0)                                              # (K,SP,WSZ)
        hx2 = torch.clamp(1.0 - torch.abs(
            wx[:, None, None] + sp_ids[None, :, None] - w_ids[None, None, :]
        ), min=0.0)
        tgt = torch.bmm(torch.bmm(hy2, win), hx2.transpose(1, 2))  # (K,SP,SP)
        diff = tgt[:, 1:-1, 1:-1] - tmpl_in + mean_diff[:, None, None]
        accum = torch.stack([
            torch.sum(diff * gx, (1, 2)),
            torch.sum(diff * gy, (1, 2)),
            torch.sum(diff, (1, 2)),
        ], -1)                                                   # (K,3)
        upd = (Hinv @ accum[:, :, None])[:, :, 0]
        new_pos = pos - upd[:, :2] * scale[:, None]
        new_mean = mean_diff - upd[:, 2]
        conv = (upd[:, 0] ** 2 + upd[:, 1] ** 2) < conv_limit * conv_limit
        active = ~(done | off_edge)
        pos = torch.where(active[:, None], new_pos, pos)
        mean_diff = torch.where(active, new_mean, mean_diff)
        done = done | conv
        ok = ok & ~off_edge
    return pos, done & ok
