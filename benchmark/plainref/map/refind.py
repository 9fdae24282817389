"""Data-association refinds: search existing points again in keyframes
that lack a measurement of them (port of mcptam_tpu/map/refind.py, ref
ReFind_Common / ReFindInSingleKeyFrame / ReFindNewlyMade,
src/MapMakerServerBase.cc:921-1060).

Each candidate (keyframe, point) pair is projected, a warped template is
made from the point's source keyframe, the stored keyframe image is
ZMSSD-searched in a small radius, and a subpixel-converged match becomes a
SRC_REFIND measurement.  All pairs run at once, pair axis first.
"""

from __future__ import annotations

import torch

from plainref.core.camera import (
    CameraModel, cam_sphere_deriv, project, projection_derivs_sphere,
)
from plainref.core.se3 import SE3
from plainref.map.builder import add_measurements
from plainref.map.state import SRC_REFIND, MapState, kf_cam_from_world
from plainref.ops.patch import (
    find_patch_w, make_warped_template_w, subpix_refine_w, warp_and_search_level,
)

REFIND_RANGE = 7   # level-0 px search radius around the projection
MAX_REFINDS = 512  # pairs per invocation


def _pair_table(ms: MapState, mkf, cam, pt, mask) -> torch.Tensor:
    """(M,C,N) bool: any(mask) over the pairs (mkf, cam, pt)."""
    M, C, N = ms.no_retry.shape
    flat = (mkf.long() * C + cam.long()) * N + pt.long()
    out = torch.zeros(M * C * N, dtype=torch.int32, device=mask.device)
    return (out.scatter_reduce(0, flat, mask.to(torch.int32), reduce="amax")
            > 0).reshape(M, C, N)


def measurement_table(ms: MapState) -> torch.Tensor:
    """(M,C,N) bool: does keyframe (mkf, cam) already measure point n?"""
    m = ms.meas
    return _pair_table(ms, m.mkf, m.cam, m.point, m.valid)


def refind_in_keyframes(ms: MapState, cams: CameraModel, target_mkf_mask=None,
                        max_refinds: int = MAX_REFINDS, pair_mask=None):
    """Attempt refinds of every live point in every keyframe missing it,
    optionally restricted to MKFs in target_mkf_mask or to explicit
    (M,C,N) pairs (the failure-queue retry, ReFindFromFailureQueue).
    Attempted pairs that fail become never-retry and every attempted pair
    leaves the failure queue.  Updates ms; returns (ms, n_added)."""
    M, C, N = ms.no_retry.shape
    if target_mkf_mask is None:
        target_mkf_mask = ms.mkfs.valid

    kcw = kf_cam_from_world(ms)
    p_c = (torch.einsum("mcij,nj->mcni", kcw.R, ms.points.pos_w)
           + kcw.t[:, :, None, :])                                 # (M,C,N,3)
    uv, proj_ok = project(cams[None, :, None], p_c)

    has = measurement_table(ms)
    live = (ms.points.valid & ~ms.points.bad)[None, None, :]
    slot_ok = (target_mkf_mask[:, None, None] & ms.mkfs.kf_valid[:, :, None]
               & ms.mkfs.valid[:, None, None])
    cand = proj_ok & ~has & live & ~ms.no_retry & slot_ok
    # pairs whose projection already failed go straight to never-retry
    proj_dead = ~proj_ok & ~has & live & slot_ok
    if pair_mask is not None:
        cand = cand & pair_mask
        proj_dead = proj_dead & pair_mask

    # the first max_refinds candidates by index, then non-candidates by
    # index: the order jax.lax.top_k gives 0/-inf priorities
    flat = cand.reshape(-1)
    idx = torch.argsort((~flat).to(torch.int8), stable=True)[:max_refinds]
    sel_ok = flat[idx]
    mkf = torch.div(idx, C * N, rounding_mode="floor")
    cam = torch.div(idx, N, rounding_mode="floor") % C
    pt = idx % N
    uv_pred = uv.reshape(-1, 2)[idx]

    pts = ms.points
    pose = SE3(R=kcw.R[mkf, cam], t=kcw.t[mkf, cam])
    pc = pose.apply(pts.pos_w[pt])
    cam_p = cams[cam]
    d_th, d_ph = cam_sphere_deriv(pc)
    warp, slvl, w_ok = warp_and_search_level(
        projection_derivs_sphere(cam_p, pc), d_th, d_ph, pose.R,
        pts.pixel_right_w[pt], pts.pixel_down_w[pt])
    tmpl, t_ok = make_warped_template_w(
        ms.mkfs.atlas, pts.src_mkf[pt], pts.src_cam[pt], pts.src_level[pt],
        pts.center_xy[pt], warp, slvl)
    found, pos, _ = find_patch_w(ms.mkfs.atlas, ms.mkfs.corner_atlas, mkf, cam,
                                 slvl, tmpl, uv_pred, REFIND_RANGE)
    found = found & sel_ok & w_ok & t_ok
    pos_sub, conv = subpix_refine_w(ms.mkfs.atlas, mkf, cam, slvl, tmpl, pos, 10)
    got = found & conv
    pos = torch.where(conv[:, None], pos_sub, pos)

    K = max_refinds
    dev = got.device
    ms = add_measurements(
        ms, mkf=mkf, cam=cam, point=pt, level=slvl, uv_l0=pos, want=got,
        source=torch.full((K,), SRC_REFIND, dtype=torch.int32, device=dev),
        subpix=torch.ones(K, dtype=torch.bool, device=dev))
    ms.no_retry = ms.no_retry | _pair_table(ms, mkf, cam, pt, sel_ok & ~got) | proj_dead
    ms.retry_queue = (ms.retry_queue & ~_pair_table(ms, mkf, cam, pt, sel_ok)
                      & ~proj_dead)
    return ms, torch.sum(got)
