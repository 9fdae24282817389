"""MiniPatch: unwarped 9x9 SSD patch search and the temporal candidate
stability filter (port of mcptam_tpu/ops/minipatch.py, ref
src/MiniPatch.cc:61-127 and MakeKeyFrame_Rest, src/KeyFrame.cc:456-529).

Each candidate corner is tracked from the current frame into the previous
one and back; it survives when it returns within 2 px.  Every function is
batched over a leading candidate axis.  The round trip of every candidate
of a frame runs as one launch of ``csrc/minipatch.cu`` on the card
(``ops/minipatch_kernel.py::stability_search``; a CPU tensor takes its
plain version).  ``mini_template`` and ``mini_search`` read their windows
through ``gather_unaligned`` (K8, ``csrc/gather_unaligned.cu`` on the
card).  A window that does not lie inside its image carries ``ok`` False
and is masked out, exactly as the JAX package masks its clamped
``dynamic_slice`` windows, so wherever ``ok`` holds the two packages read
the same pixels.
"""

from __future__ import annotations

import dataclasses

import torch

from mcptam_tpu_torch.ops.gather_unaligned_kernel import gather_unaligned
from mcptam_tpu_torch.ops.minipatch_kernel import (
    MAX_SSD, RETURN_TOL, STABILITY_RADIUS, Images, level_descriptors,
    search as _search, single_descriptors, stability_search, template as _template,
)


def _single(img: torch.Tensor) -> Images:
    return Images(img.contiguous(), 0, 0, img.shape[0], img.shape[1])


def mini_template(img: torch.Tensor, xy: torch.Tensor):
    """(K,9,9) templates of an (h,w) image centred at the rounded (K,2)
    xy = (x, y), and whether each lies inside the image."""
    return _template(_single(img), xy, gather_unaligned)


def mini_search(img: torch.Tensor, template: torch.Tensor, pred_xy: torch.Tensor,
                radius: int = STABILITY_RADIUS, max_ssd: float = MAX_SSD):
    """Plain-SSD search of (K,9,9) templates around (K,2) predictions over
    every offset within ``radius`` (ref FindPatch, src/MiniPatch.cc:61-113).
    Returns (found (K,), xy (K,2) f32, ssd (K,))."""
    return _search(_single(img), template, pred_xy, radius, max_ssd, gather_unaligned)


def stability_filter(prev_img: torch.Tensor, cur_img: torch.Tensor,
                     cand_xy: torch.Tensor, cand_valid: torch.Tensor,
                     radius: int = STABILITY_RADIUS, tol: float = RETURN_TOL):
    """Round-trip stability of (K,2) level-coordinate candidates between two
    (h,w) images of one level: track cur -> prev -> cur, keep those that
    return within ``tol`` px.  Returns the pruned validity mask (K,)."""
    h, w = cur_img.shape
    desc = single_descriptors(h, w, cand_xy.shape[0], cur_img.device)
    return stability_search(prev_img.to(torch.float32), cur_img.to(torch.float32), desc,
                            cand_xy, cand_valid, radius, tol).kept


def filter_frame_candidates(prev_feats, feats):
    """The stability filter on every camera and level of a FrameFeatures
    pair (previous frame, current frame), all candidates in one batch read
    straight from the (C*H, AW) atlas planes.  Returns feats with the pruned
    ``cand_valid``."""
    C, H, AW = feats.atlas.shape
    sizes = [v.shape[1] for v in feats.cand_valid]
    desc = level_descriptors(C, H, AW, tuple(sizes), feats.atlas.device)
    xy = torch.cat([xy.reshape(-1, 2) for xy in feats.cand_xy])
    valid = torch.cat([v.reshape(-1) for v in feats.cand_valid])
    kept = stability_search(prev_feats.atlas.reshape(C * H, AW),
                            feats.atlas.reshape(C * H, AW), desc, xy, valid).kept
    new_valid = tuple(v.reshape(C, -1) for v in torch.split(kept, [C * k for k in sizes]))
    return dataclasses.replace(feats, cand_valid=new_valid)
