"""Batched patch search: the tracker's hot path (port of
mcptam_tpu/ops/batch_patch.py, ref src/PatchFinder.cc).

Stages, each over K (camera, point) pairs at once:
  * warped 8x8 template by bilinear (hat-weight) sampling of the point's
    stored source window (MakeTemplateCoarseCont, :135-182);
  * dense ZMSSD at every offset of a search region, first-index argmin,
    and the subpixel window at the best offset (FindPatchCoarse + the SSE
    ZMSSD kernel, :229-355, :491-658): ``ops/search_kernel.py``, one
    fused CUDA kernel on the card;
  * inverse-composition subpixel refinement resampled inside that window
    (IterateSubPixToConvergence, :396-470).

The keyframe-store gathers go through ``ops/gather_kernel.gather_windows``
(the CUDA window gather on the card).  Unlike the reference, tensors keep
the pair axis first: the reference's pair-axis-last layout served TPU
vector lanes.
"""

from __future__ import annotations

import torch

from mcptam_tpu_torch.config import PATCH_SIZE
from mcptam_tpu_torch.core.levels import level_n_pos
from mcptam_tpu_torch.core.linalg import inv3
from mcptam_tpu_torch.ops.atlas import level_xoff_array, _level0_width_from_atlas
from mcptam_tpu_torch.ops.gather_kernel import gather_windows
from mcptam_tpu_torch.ops.patch import HALF, _SUBPIX_PAD
from mcptam_tpu_torch.ops.search_kernel import gather_windows3, search_patches  # noqa: F401

_SRC_HALF = 12  # template source window half-size


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


# Batched FindPatchCoarse over K pairs: the fused search kernel on the
# card, its plain version on the CPU (ops/search_kernel.py).
find_patches = search_patches


def subpix_refine_region(aux, level_hw, search_level, templates, pos_l0,
                         n_its: int = 10, conv_limit: float = 0.03):
    """Subpixel refinement resampling from the (15,15) window find_patches
    cut out of its search region at the best offset: no gather."""
    return _subpix_iterate(aux["win"], aux["region_ok"], level_hw, search_level,
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
