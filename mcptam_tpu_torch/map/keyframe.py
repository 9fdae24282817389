"""Per-frame feature preparation, the MakeKeyFrame_Lite/_Rest analogue
(port of mcptam_tpu/map/keyframe.py, ref src/KeyFrame.cc:145-537).

One camera-batched computation produces the pyramid atlas, the FAST
corner atlas with adaptive per-level thresholds, the nonmax candidate
lists per level (static-, glare- and border-masked) and the SBI templates.
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

CANDIDATE_BORDER = 10  # ref KeyFrame.cc:402 in_image_with_border(ir, 10)


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
                        glare_masking: bool = False) -> FrameFeatures:
    """images: (C,H,W) uint8 or float [0,255] on the device to compute on.
    static_masks: (C,H,W) bool, True where features may be taken (the
    reference's per-camera mask images, src/SystemBase.cc:218-248), or None.
    glare_masking: also exclude saturated regions (glare_mask)."""
    C, H, W = images.shape
    images = images.to(torch.float32)
    pyr = build_pyramid(images)

    # usable pixels per level: the static mask taken every 2nd pixel per
    # level, and the glare mask of the level image
    masks = []
    for l in range(LEVELS):
        m = None
        if static_masks is not None:
            m = static_masks.to(torch.bool)
            for _ in range(l):
                m = m[..., ::2, ::2]
        if glare_masking:
            g = glare_mask(pyr[l])
            m = g if m is None else m & g
        masks.append(m)

    # FAST score + 3x3 nonmax + cumulative threshold histograms of every
    # level (one CUDA kernel launch on the card)
    fronts = fast_frontend_levels([p.contiguous() for p in pyr])

    thresholds, corner_maps, counts = [], [], []
    for l in range(LEVELS):
        score, _, freq, _ = fronts[l]
        h, w = score.shape[-2:]
        if fcfg.adaptive_thresh:
            t = adaptive_threshold_from_freq(
                freq, h * w, fcfg.min_fast_thresh, fcfg.max_fast_thresh,
                fcfg.adapt_target_divisor,
            )
        else:
            t = torch.full((C,), float(fcfg.fixed_thresholds[l]),
                           device=images.device)
        cm = score > (t - 1e-6)[:, None, None]
        if masks[l] is not None:
            cm = cm & masks[l]
        thresholds.append(t)
        corner_maps.append(cm)
        counts.append(torch.sum(cm, (-2, -1), dtype=torch.int32))

    atlas = build_atlas(pyr)
    corner_atlas = build_atlas([m.to(torch.float32) for m in corner_maps])

    # candidates: nonmax corners above a capacity-adapted cutoff from the
    # nonmax histogram, compacted in raster order (src/KeyFrame.cc:363-452)
    cand_xy, cand_score, cand_valid = [], [], []
    for l in range(LEVELS):
        _, nm, _, freq_nm = fronts[l]
        k = min(MAX_CANDIDATES_PER_LEVEL[l], (H >> l) * (W >> l))
        h, w = nm.shape[-2:]
        usable = _border_mask(h, w, CANDIDATE_BORDER, images.device).expand(C, h, w)
        if masks[l] is not None:
            usable = usable & masks[l]
        cutoff = cutoff_from_freq(freq_nm, thresholds[l], k)
        xy, vals, valid = select_corners_cutoff(
            nm, usable, cutoff, k, floor=thresholds[l]
        )
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
