"""Patch-warp selection and the constants of the patch search (port of the
tracking subset of mcptam_tpu/ops/patch.py, ref src/PatchFinder.cc)."""

from __future__ import annotations

import torch

from mcptam_tpu_torch.config import LEVELS, PATCH_SIZE

HALF = PATCH_SIZE // 2  # patch centre offset (4,4), ref PatchFinder.cc:60
MAX_SSD_PER_PIXEL = 250.0
MAX_SSD = PATCH_SIZE * PATCH_SIZE * MAX_SSD_PER_PIXEL
PACK_CORNER = 1024.0  # corner flag packed above the 8-bit pixel range

# Max drift (search-level px) the single gathered subpixel window allows.
_SUBPIX_PAD = 3


def warp_and_search_level(cam_derivs, d_theta, d_phi, R_cam_from_world,
                          pixel_right_w, pixel_down_w):
    """Patch warp and search level for (...) (point, camera) pairs
    (src/PatchFinder.cc:69-122).

    cam_derivs (...,2,2); d_theta/d_phi (...,3); R_cam_from_world
    (...,3,3); pixel_right_w/pixel_down_w (...,3), all broadcasting.
    Returns (warp_inv (...,2,2), search_level int64 (...), ok (...))."""
    mr = torch.einsum("...ij,...j->...i", R_cam_from_world, pixel_right_w)
    md = torch.einsum("...ij,...j->...i", R_cam_from_world, pixel_down_w)
    sph_r = torch.stack([torch.sum(d_theta * mr, -1), torch.sum(d_phi * mr, -1)], -1)
    sph_d = torch.stack([torch.sum(d_theta * md, -1), torch.sum(d_phi * md, -1)], -1)
    col_r = torch.einsum("...ij,...j->...i", cam_derivs, sph_r)
    col_d = torch.einsum("...ij,...j->...i", cam_derivs, sph_d)
    A = torch.stack([col_r, col_d], -1)  # columns
    det = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]

    # quarter the det until <= 3 (or out of levels)
    lvl = torch.zeros(det.shape, dtype=torch.int64, device=det.device)
    d = det
    for _ in range(LEVELS - 1):
        step = d > 3.0
        lvl = lvl + step.to(torch.int64)
        d = torch.where(step, d * 0.25, d)
    ok = (d <= 3.0) & (d >= 0.5) & torch.isfinite(det)
    return A, lvl, ok


def pack_corner_atlas(atlas, corner_atlas):
    """img + 1024*corner: one plane, so the search needs a single gather."""
    return atlas + PACK_CORNER * corner_atlas


# ---------------------------------------------------------------------------
# Keyframe-store searches (the reference's ``_w`` functions over
# make_window_fn4), pair-batched: every argument carries a leading pair
# axis and the windows come out of the (M,C,H,AW) keyframe atlases through
# batch_patch.gather_windows4, i.e. the window-gather kernel.
# ---------------------------------------------------------------------------

def _level_hw(atlas4):
    from mcptam_tpu_torch.ops.atlas import _level0_width_from_atlas, level_size_arrays
    return level_size_arrays(atlas4.shape[-2], _level0_width_from_atlas(atlas4.shape[-1]),
                             atlas4.device)


def zmssd(template, patches):
    """Zero-mean SSD between (...,8,8) templates and (...,8,8) patches."""
    n = PATCH_SIZE * PATCH_SIZE
    t = template.reshape(template.shape[:-2] + (n,))
    p = patches.reshape(patches.shape[:-2] + (n,))
    ssd = torch.sum((p - t) ** 2, -1)
    return ssd - (torch.sum(p, -1) - torch.sum(t, -1)) ** 2 / n


def make_warped_template_w(atlas4, mkf, cam, src_level, src_center_xy,
                           warp_inv, search_level):
    """(K,) pairs: 8x8 warped templates sampled from source keyframe
    (mkf, cam) at src_level around src_center_xy (MakeTemplateCoarseCont,
    src/PatchFinder.cc:135-182).  Returns (templates (K,8,8), ok (K,))."""
    from mcptam_tpu_torch.ops.batch_patch import (
        _SRC_HALF, gather_windows4, make_warped_templates,
    )
    cxi = torch.floor(src_center_xy[:, 0]).to(torch.int64)
    cyi = torch.floor(src_center_xy[:, 1]).to(torch.int64)
    win, win_ok = gather_windows4(atlas4, mkf.long(), cam.long(), src_level.long(),
                                  cyi - _SRC_HALF, cxi - _SRC_HALF,
                                  2 * _SRC_HALF + 2)
    return make_warped_templates(win, win_ok, _level_hw(atlas4), src_level.long(),
                                 src_center_xy.to(torch.float32), warp_inv,
                                 search_level)


def find_patch_w(atlas4, corner_atlas4, mkf, cam, search_level, template,
                 pred_pos_l0, range_l0: int, max_range_l0=None,
                 exhaustive: bool = False, max_ssd: float = MAX_SSD):
    """(K,) pairs: coarse ZMSSD search in keyframe (mkf, cam) around the
    prediction, corners read from the separate corner atlas
    (FindPatchCoarse, src/PatchFinder.cc:229-355).  The sums run in the
    reference's order.  Returns (found, pos_l0 (K,2), best_ssd)."""
    from mcptam_tpu_torch.core.levels import level_n_pos, level_zero_pos
    from mcptam_tpu_torch.ops.batch_patch import gather_windows4
    from mcptam_tpu_torch.ops.search_kernel import _box8

    K = template.shape[0]
    lvl = search_level.long()
    lvl_f = lvl.to(torch.float32)
    pos_lev = level_n_pos(pred_pos_l0, lvl_f[:, None])
    max_r = float(range_l0) if max_range_l0 is None else max_range_l0
    r_lev = torch.ceil(max_r / torch.exp2(lvl_f))

    R = range_l0
    S = 2 * R + 1
    G = S + PATCH_SIZE
    cyi = torch.round(pos_lev[:, 1]).to(torch.int64)   # half to even, as jnp
    cxi = torch.round(pos_lev[:, 0]).to(torch.int64)
    y0 = cyi - R - HALF
    x0 = cxi - R - HALF
    mkf, cam = mkf.long(), cam.long()
    region, region_ok = gather_windows4(atlas4, mkf, cam, lvl, y0, x0, G)
    corner_w, _ = gather_windows4(corner_atlas4, mkf, cam, lvl, y0 + HALF,
                                  x0 + HALF, S)

    hs, ws = _level_hw(atlas4)
    h_l = hs[lvl].to(torch.float32)[:, None, None]
    w_l = ws[lvl].to(torch.float32)[:, None, None]
    d = torch.arange(S, dtype=torch.float32, device=template.device) - R
    yy = cyi.to(torch.float32)[:, None, None] + d[None, :, None]
    xx = cxi.to(torch.float32)[:, None, None] + d[None, None, :]
    dist_ok = ((yy - pos_lev[:, 1, None, None]) ** 2
               + (xx - pos_lev[:, 0, None, None]) ** 2) <= (r_lev * r_lev + 1e-6)[:, None, None]
    in_bounds = (xx >= HALF) & (yy >= HALF) & (xx < w_l - HALF) & (yy < h_l - HALF)
    valid = dist_ok & in_bounds & ((corner_w > 0.5) | exhaustive) & region_ok[:, None, None]

    n = PATCH_SIZE * PATCH_SIZE
    sum_p = _box8(region, S)
    sum_p2 = _box8(region * region, S)
    cross = sum(region[:, py:py + S, px:px + S] * template[:, py, px, None, None]
                for py in range(PATCH_SIZE) for px in range(PATCH_SIZE))
    sum_t = torch.sum(template, (1, 2))[:, None, None]
    sum_t2 = torch.sum(template * template, (1, 2))[:, None, None]
    scores = sum_p2 - 2.0 * cross + sum_t2 - (sum_p - sum_t) ** 2 / n
    scores = torch.where(valid, scores, torch.full_like(scores, float("inf")))
    best_ssd, best = torch.min(scores.reshape(K, S * S), 1)   # first minimum
    by = torch.div(best, S, rounding_mode="floor")
    bx = best % S
    pos_lev_best = torch.stack([(cxi + bx - R).to(torch.float32),
                                (cyi + by - R).to(torch.float32)], -1)
    return best_ssd < max_ssd, level_zero_pos(pos_lev_best, lvl_f[:, None]), best_ssd


def subpix_refine_w(atlas4, mkf, cam, search_level, template, pos_l0,
                    n_its: int = 10, conv_limit: float = 0.03):
    """(K,) pairs: inverse-composition subpixel refinement in keyframe
    (mkf, cam) from one gathered window (IterateSubPixToConvergence,
    src/PatchFinder.cc:396-470).  Returns (pos_l0 (K,2), converged)."""
    from mcptam_tpu_torch.core.levels import level_n_pos
    from mcptam_tpu_torch.ops.batch_patch import _subpix_iterate, gather_windows4

    lvl = search_level.long()
    P = _SUBPIX_PAD
    base0 = level_n_pos(pos_l0, lvl.to(torch.float32)[:, None]) - HALF
    byi0 = torch.floor(base0[:, 1]).to(torch.int64) - P
    bxi0 = torch.floor(base0[:, 0]).to(torch.int64) - P
    win, win_ok = gather_windows4(atlas4, mkf.long(), cam.long(), lvl, byi0, bxi0,
                                  PATCH_SIZE + 1 + 2 * P)
    return _subpix_iterate(win, win_ok, _level_hw(atlas4), lvl, template,
                           pos_l0.to(torch.float32), n_its, conv_limit)
