"""The tracker's patch search over K (camera, point) pairs: the region
gather, the ZMSSD at every offset, the masks, the first-index argmin and
the subpixel window at the best offset (port of
mcptam_tpu/ops/batch_patch.py::find_patches with the window cut of
subpix_refine_region).

A CUDA atlas launches the fused kernel ``csrc/search.cu``, one launch for
all pairs, whose region stays in shared memory; a CPU atlas takes
``search_patches_reference``: the window gather, then the eager search.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mcptam_tpu_torch import backend
from mcptam_tpu_torch.config import PATCH_SIZE
from mcptam_tpu_torch.core.levels import level_n_pos, level_zero_pos
from mcptam_tpu_torch.ops.atlas import _level0_width_from_atlas, level_xoff_array
from mcptam_tpu_torch.ops.gather_kernel import gather_windows
from mcptam_tpu_torch.ops.patch import HALF, MAX_SSD, PACK_CORNER, _SUBPIX_PAD

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
    """Batched FindPatchCoarse over K pairs, the search radius range_l0
    (level pixels) fixing the region's size.

    packed_atlas3: pack_corner_atlas(atlas, corner_atlas) (C,H,AW) f32;
    level_hw: level_size_arrays of its level-0 size; cam_idx, search_level:
    (K,) integer; templates (K,8,8); pred_pos_l0 (K,2); max_range_l0: the
    radius (<= range_l0, level-0 px) actually enforced, a number or a
    scalar tensor; exhaustive: a bool or (K,) bool (search every offset,
    not only FAST corners).  box: an optional (2,K,S,S) f32 tensor that
    receives the box sums sum_p and sum_p2 (for checking).
    Returns (found (K,), pos_l0 (K,2), best_ssd (K,), aux) with aux =
    dict(win (K,15,15) subpixel window at the best offset, region_ok, by,
    bx)."""
    dev = packed_atlas3.device
    if dev.type == "cpu":
        return search_patches_reference(packed_atlas3, level_hw, cam_idx, search_level,
                                        templates, pred_pos_l0, range_l0, max_range_l0,
                                        exhaustive, max_ssd, box)
    if dev.type != "cuda":
        raise ValueError(f"search_patches: unsupported device {dev}")
    if (packed_atlas3.dtype != torch.float32 or packed_atlas3.ndim != 3
            or not packed_atlas3.is_contiguous()):
        raise ValueError("search_patches takes a contiguous (C,H,AW) float32 atlas, got "
                         f"{packed_atlas3.dtype} {tuple(packed_atlas3.shape)}")
    K = cam_idx.shape[0]
    C, H, AW = packed_atlas3.shape
    S = 2 * range_l0 + 1
    tmpl = templates.to(torch.float32).contiguous()
    pred = pred_pos_l0.to(torch.float32).contiguous()
    cam = cam_idx.to(torch.int64).contiguous()
    lvl = search_level.to(torch.int64).contiguous()
    if (tmpl.shape != (K, PATCH_SIZE, PATCH_SIZE) or pred.shape != (K, 2)
            or cam.shape != (K,) or lvl.shape != (K,) or tmpl.data_ptr() % 16):
        raise ValueError("search_patches: bad pair tensors")
    hs, ws = level_hw
    hs, ws = hs.to(torch.int64).contiguous(), ws.to(torch.int64).contiguous()
    xoffs = level_xoff_array(_level0_width_from_atlas(AW), dev)
    exh_ptr, exh_all = None, 0
    if isinstance(exhaustive, torch.Tensor) and exhaustive.ndim:
        exh = exhaustive.to(torch.bool).contiguous()
        if exh.shape != (K,):
            raise ValueError(f"search_patches: exhaustive of shape {tuple(exh.shape)}")
        exh_ptr = exh.data_ptr()
    else:
        exh_all = int(bool(exhaustive))
    mr_ptr, mr_val = None, 0.0
    if isinstance(max_range_l0, torch.Tensor):
        mr = max_range_l0.to(torch.float32).contiguous()
        if mr.numel() != 1:
            raise ValueError("search_patches: max_range_l0 must be a scalar")
        mr_ptr = mr.data_ptr()
    else:
        mr_val = float(max_range_l0)
    tensors = (tmpl, pred, cam, lvl, hs, ws, xoffs) + (
        (exh,) if exh_ptr else ()) + ((mr,) if mr_ptr else ())
    if any(x.device != dev for x in tensors):
        raise ValueError("search_patches: every tensor must lie on the atlas' device")
    if box is not None and (box.shape != (2, K, S, S) or box.dtype != torch.float32
                            or not box.is_contiguous() or box.device != dev):
        raise ValueError("search_patches: box must be a contiguous (2,K,S,S) float32 tensor")
    from mcptam_tpu_torch.csrc._build import check, load

    found = torch.empty(K, dtype=torch.bool, device=dev)
    region_ok = torch.empty(K, dtype=torch.bool, device=dev)
    pos_l0 = torch.empty((K, 2), dtype=torch.float32, device=dev)
    best_ssd = torch.empty(K, dtype=torch.float32, device=dev)
    by = torch.empty(K, dtype=torch.int64, device=dev)
    bx = torch.empty(K, dtype=torch.int64, device=dev)
    win = torch.empty((K, WSZ, WSZ), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = load().mcptam_search_patches(
        packed_atlas3.data_ptr(), cam.data_ptr(), lvl.data_ptr(), tmpl.data_ptr(),
        pred.data_ptr(), hs.data_ptr(), ws.data_ptr(), xoffs.data_ptr(), exh_ptr, exh_all,
        mr_ptr, mr_val, float(max_ssd), K, H, AW, range_l0, found.data_ptr(),
        pos_l0.data_ptr(), best_ssd.data_ptr(), by.data_ptr(), bx.data_ptr(),
        region_ok.data_ptr(), win.data_ptr(), None if box is None else box.data_ptr(),
        stream)
    check(err, "search_patches")
    backend.count_launch("search_patches")
    return found, pos_l0, best_ssd, dict(win=win, region_ok=region_ok, by=by, bx=bx)
