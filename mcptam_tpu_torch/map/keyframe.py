"""Per-frame feature preparation, the MakeKeyFrame_Lite/_Rest analogue
(port of mcptam_tpu/map/keyframe.py, ref src/KeyFrame.cc:145-537).

One camera-batched computation produces the pyramid atlas, the FAST
corner atlas with adaptive per-level thresholds, the nonmax candidate
lists per level (static-, glare- and border-masked) and the SBI templates.

With a process group (parallel/mesh.py) the image rows are sharded: each
rank builds the pyramid of its block of rows plus a halo, scores it with
the FAST kernel, counts the histograms over its own rows only, and the
histograms, corner counts, level bands and candidate lists are reduced or
gathered so that every rank gets the unsharded features, exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from mcptam_tpu_torch.config import (
    LEVELS, MAX_CANDIDATES_PER_LEVEL, FeatureConfig, DEFAULT_FEATURES,
)
from mcptam_tpu_torch.ops.atlas import build_atlas
from mcptam_tpu_torch.ops.fast import (
    adaptive_threshold_from_freq, cutoff_from_freq, select_corners_cutoff,
)
from mcptam_tpu_torch.ops.fast_kernel import fast_frontend_levels
from mcptam_tpu_torch.ops.pyramid import build_pyramid
from mcptam_tpu_torch.ops.sbi import make_sbi, sbi_gradients
from mcptam_tpu_torch.parallel.collectives import all_reduce, gather_cat, rank_world

CANDIDATE_BORDER = 10  # ref KeyFrame.cc:402 in_image_with_border(ir, 10)
# a row shard's halo in level-0 rows: 4 at level 3, which covers FAST's
# ring of radius 3 plus the 1 of the 3x3 nonmax at every level
ROW_HALO = 32
ROW_ALIGN = 1 << (LEVELS - 1)  # shard boundaries halve exactly to level 3


@dataclass
class FrameFeatures:
    atlas: torch.Tensor          # (C,H,AW) f32 pyramid atlas
    corner_atlas: torch.Tensor   # (C,H,AW) f32 0/1 thresholded FAST corners
    thresholds: torch.Tensor     # (C,LEVELS) chosen FAST thresholds
    corner_counts: torch.Tensor  # (C,LEVELS) corners per level
    cand_xy: tuple               # per level: (C,K_l,2) int32 level coords
    cand_score: tuple            # per level: (C,K_l)
    cand_valid: tuple            # per level: (C,K_l) bool
    sbi: torch.Tensor            # (C,ROWS,COLS)
    sbi_gx: torch.Tensor
    sbi_gy: torch.Tensor


def glare_mask(img: torch.Tensor, radius: int = 2, iters: int = 5,
               thresh: float = 245.0) -> torch.Tensor:
    """True where usable (not glare): the reference's 5x5-ellipse dilation
    applied 5 times, then threshold > 245 inverted (src/KeyFrame.cc:214-220).
    Shifts wrap around the image edges, as in the JAX package."""
    shifts = [(dy, dx) for dy in range(-radius, radius + 1)
              for dx in range(-radius, radius + 1)
              if (dy, dx) != (0, 0) and abs(dy) + abs(dx) <= radius + 1]
    d = img
    for _ in range(iters):
        m = d
        for dy, dx in shifts:
            m = torch.maximum(m, torch.roll(d, (dy, dx), (-2, -1)))
        d = m
    return d <= thresh


def _border_mask(H: int, W: int, border: int, device) -> torch.Tensor:
    ys = torch.arange(H, device=device)[:, None]
    xs = torch.arange(W, device=device)[None, :]
    return (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)


def make_frame_features(images: torch.Tensor, static_masks=None,
                        fcfg: FeatureConfig = DEFAULT_FEATURES,
                        glare_masking: bool = False, group=None) -> FrameFeatures:
    """images: (C,H,W) uint8 or float [0,255] on the device to compute on.
    static_masks: (C,H,W) bool, True where features may be taken (the
    reference's per-camera mask images, src/SystemBase.cc:218-248), or None.
    glare_masking: also exclude saturated regions (glare_mask).
    group: a process group to shard the image rows over; every rank passes
    the whole images and gets the whole features.  Rank r of n owns the
    rows [r H/n, (r+1) H/n) (``row_slab``) and builds the pyramid of them
    plus ROW_HALO rows each side; the FAST kernel counts the histograms
    over the owned rows of each level.  The summed histograms give every
    rank the same thresholds and cutoffs; the owned bands of each level and
    corner map are gathered into the atlases, the corner counts summed, and
    the ranks' candidates merged in rank order.  The SBI is made from the
    whole images on every rank.  Glare masking dilates across the whole
    image and is not offered under a group."""
    if group is not None and glare_masking:
        raise ValueError("row-sharded frame features take no glare mask")
    C, H, W = images.shape
    r0, _, s0, s1, rows = row_slab(H, *rank_world(group))
    images = images.to(torch.float32)
    pyr = build_pyramid(images[:, s0:s1])

    # usable pixels of each level's owned rows: the static mask taken every
    # 2nd pixel per level, and the glare mask of the level image
    masks = []
    for l in range(LEVELS):
        m = None
        if static_masks is not None:
            m = static_masks.to(torch.bool)
            for _ in range(l):
                m = m[..., ::2, ::2]
            a, b = rows[l]
            m = m[:, (r0 >> l):(r0 >> l) + b - a]
        if glare_masking:
            g = glare_mask(pyr[l])
            m = g if m is None else m & g
        masks.append(m)

    # FAST score + 3x3 nonmax + cumulative threshold histograms over the
    # owned rows of every level (one CUDA kernel launch on the card)
    fronts = fast_frontend_levels([p.contiguous() for p in pyr], rows=rows)

    thresholds, bands, corner_bands, counts = [], [], [], []
    for l in range(LEVELS):
        score, _, freq, _ = fronts[l]
        a, b = rows[l]
        if fcfg.adaptive_thresh:
            t = adaptive_threshold_from_freq(
                all_reduce(freq, group), (H >> l) * (W >> l), fcfg.min_fast_thresh,
                fcfg.max_fast_thresh, fcfg.adapt_target_divisor,
            )
        else:
            t = torch.full((C,), float(fcfg.fixed_thresholds[l]),
                           device=images.device)
        cm = score[:, a:b] > (t - 1e-6)[:, None, None]
        if masks[l] is not None:
            cm = cm & masks[l]
        thresholds.append(t)
        bands.append(pyr[l][:, a:b])
        corner_bands.append(cm.to(torch.float32))
        counts.append(all_reduce(torch.sum(cm, (-2, -1), dtype=torch.int32), group))

    atlas = build_atlas([gather_cat(x, group, 1) for x in bands])
    corner_atlas = build_atlas([gather_cat(x, group, 1) for x in corner_bands])

    # candidates: nonmax corners above a capacity-adapted cutoff from the
    # nonmax histogram, compacted in raster order (src/KeyFrame.cc:363-452)
    cand_xy, cand_score, cand_valid = [], [], []
    for l in range(LEVELS):
        _, nm, _, freq_nm = fronts[l]
        a, b = rows[l]
        h, w = H >> l, W >> l
        k = min(MAX_CANDIDATES_PER_LEVEL[l], h * w)
        g0 = r0 >> l                                  # the owned rows' first
        usable = _border_mask(h, w, CANDIDATE_BORDER, images.device)[g0:g0 + b - a]
        usable = usable.expand(C, b - a, w)
        if masks[l] is not None:
            usable = usable & masks[l]
        cutoff = cutoff_from_freq(all_reduce(freq_nm, group), thresholds[l], k)
        xy, vals, valid = select_corners_cutoff(
            nm[:, a:b].contiguous(), usable, cutoff, k, floor=thresholds[l]
        )
        if group is not None:
            xy = xy + torch.tensor([0, g0], dtype=xy.dtype, device=xy.device)
            xy, vals, valid = _merge_candidates(xy, vals, valid, cutoff, thresholds[l],
                                                k, group)
        cand_xy.append(xy)
        cand_score.append(vals)
        cand_valid.append(valid)

    sbi = make_sbi(images)
    gx, gy = sbi_gradients(sbi)
    return FrameFeatures(
        atlas=atlas, corner_atlas=corner_atlas,
        thresholds=torch.stack(thresholds, -1),
        corner_counts=torch.stack(counts, -1),
        cand_xy=tuple(cand_xy), cand_score=tuple(cand_score),
        cand_valid=tuple(cand_valid),
        sbi=sbi, sbi_gx=gx, sbi_gy=gy,
    )


def _merge_candidates(xy, vals, valid, cutoff, floor, k: int, group):
    """The ranks' candidate lists of one level, each (C,k) in
    ``select_corners_cutoff``'s order over the rank's rows, merged into the
    list it gives over the whole level: the corners above the cutoff of
    every rank in rank (raster) order, then the boundary bin's, the first
    k kept.  It is that selection again, over the gathered lists taken as
    one row; each rank's list holds every candidate the merge can keep,
    so the merge is exact."""
    xy, vals, valid = (gather_cat(x, group, 1) for x in (xy, vals, valid))
    at, score, ok = select_corners_cutoff(vals[:, None], valid[:, None], cutoff, k, floor)
    pick = at[..., 0].long()[..., None].expand(-1, -1, 2)   # place in the list
    return torch.gather(xy, 1, pick) * ok[..., None], score, ok


def row_slab(H: int, rank: int, world: int):
    """Rank ``rank`` of ``world``'s share of an image of H rows: its rows
    [r0, r1), the slab [s0, s1) it builds (ROW_HALO more each side,
    clamped at the image) and, per pyramid level, its rows' range inside
    the slab's level.  With more than one rank, H must divide by
    ROW_ALIGN x world."""
    if world > 1 and H % (ROW_ALIGN * world):
        raise ValueError(f"image rows H = {H} does not divide by {ROW_ALIGN} x the "
                         f"{world} ranks of the mesh")
    band = H // world
    r0, r1 = rank * band, (rank + 1) * band
    s0, s1 = max(r0 - ROW_HALO, 0), min(r1 + ROW_HALO, H)
    return r0, r1, s0, s1, [((r0 - s0) >> l, (r1 - s0) >> l) for l in range(LEVELS)]
