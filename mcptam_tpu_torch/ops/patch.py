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
