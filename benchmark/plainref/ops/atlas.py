"""Mipmap atlas: a whole pyramid packed side by side in one (H, AW) plane
(port of mcptam_tpu/ops/atlas.py).  A window gather at (level, x, y) is one
read at ``(y, x + xoff[level])`` whatever the level."""

from __future__ import annotations

import functools

import torch

from plainref.config import LEVELS

GAP = 16  # zero columns between levels; > any window half-width used


def atlas_xoff(W: int) -> tuple:
    """Per-level x offsets into the atlas for level-0 width W."""
    offs = []
    x = 0
    for l in range(LEVELS):
        offs.append(x)
        x += (W >> l) + GAP
    return tuple(offs)


def atlas_width(W: int) -> int:
    return atlas_xoff(W)[-1] + (W >> (LEVELS - 1))


def level_dims(H: int, W: int, level: int) -> tuple:
    """(height, width) of pyramid level ``level`` of an H x W image."""
    return (H >> level, W >> level)


def build_atlas(pyramid) -> torch.Tensor:
    """Pack pyramid levels (level 0 first, each (...,H_l,W_l)) into one
    (...,H, atlas_width) tensor."""
    H, W = pyramid[0].shape[-2], pyramid[0].shape[-1]
    offs = atlas_xoff(W)
    out = pyramid[0].new_zeros(pyramid[0].shape[:-2] + (H, atlas_width(W)))
    for l, img in enumerate(pyramid):
        h, w = img.shape[-2], img.shape[-1]
        out[..., :h, offs[l] : offs[l] + w] = img
    return out


@functools.lru_cache(maxsize=64)
def level_xoff_array(W: int, device) -> torch.Tensor:
    """(LEVELS,) atlas x offsets, cached per device (callers must not
    modify it): the patch search reads it every call."""
    return torch.tensor(atlas_xoff(W), dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=64)
def level_size_arrays(H: int, W: int, device):
    """(LEVELS,) tensors of level heights and widths, cached per device."""
    hs = torch.tensor([H >> l for l in range(LEVELS)], dtype=torch.int64,
                      device=device)
    ws = torch.tensor([W >> l for l in range(LEVELS)], dtype=torch.int64,
                      device=device)
    return hs, ws


@functools.lru_cache(maxsize=None)
def _level0_width_from_atlas(aw: int) -> int:
    """Invert atlas_width (widths are multiples of 8)."""
    W = 8
    while atlas_width(W) < aw:
        W += 8
    if atlas_width(W) != aw:
        raise ValueError(f"not a valid atlas width: {aw}")
    return W
