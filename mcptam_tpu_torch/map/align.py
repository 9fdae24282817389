"""Map alignment: dominant-plane detection and global transform / scale
(port of mcptam_tpu/map/align.py).

The reference finds a dominant plane by RANSAC over the map points and
aligns the world frame to it (MapMakerServerBase::CalcPlaneAligner,
src/MapMakerServerBase.cc:1084-1195), and applies global SE3 transforms
and scale changes to every MKF pose and point
(ApplyGlobalTransformationToMap / ApplyGlobalScaleToMap,
src/MapMakerServerBase.cc:549-596).  The RANSAC is batched: H plane
hypotheses scored against all N points at once, then an inlier-covariance
eigen-refinement of the winner.  Plain tensor code; the hypothesis
triples come from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses

import torch

from mcptam_tpu_torch.core.se3 import SE3
from mcptam_tpu_torch.map.state import MapState, refresh_pixel_vectors


def draw_triples(valid: torch.Tensor, generator: torch.Generator,
                 n_hyp: int = 128) -> torch.Tensor:
    """(n_hyp, 3) point indices, each row three distinct valid slots while
    at least three are valid: Gumbel top-3 over the slots, invalid ones
    pushed to -1e9.  The uniforms are drawn on the generator's device."""
    u = torch.rand((n_hyp, valid.shape[0]), generator=generator,
                   device=generator.device).to(valid.device)
    g = -torch.log(-torch.log(u)) + torch.where(valid, 0.0, -1e9)
    return torch.topk(g, 3, dim=-1).indices


def inlier_threshold(points_w: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """10% of the median |point - centroid| over the slots, as the
    reference computes it: its median propagates NaN, so with any slot
    invalid (the normal case in a fixed-capacity map) the median is NaN,
    taken as 1.0, and the threshold is 0.1 world units; with every slot
    valid, an even count averages the two middle values."""
    w = valid.to(points_w.dtype)
    centroid = torch.sum(points_w * w[:, None], 0) / torch.clamp(torch.sum(w), min=1)
    spread = torch.linalg.vector_norm(points_w - centroid, dim=-1)
    med = torch.quantile(torch.where(valid, spread, float("nan")), 0.5,
                         interpolation="midpoint")
    return 0.10 * torch.clamp(torch.nan_to_num(med, nan=1.0), min=1e-6)


def dominant_plane_from_triples(points_w: torch.Tensor, valid: torch.Tensor,
                                idx3: torch.Tensor):
    """The dominant plane from given hypothesis triples.

    points_w: (N,3), valid: (N,) bool, idx3: (H,3) indices.  Returns
    (center (3,), normal (3,), inlier_mask (N,), ok bool); a point is an
    inlier within ``inlier_threshold`` of the plane."""
    nv = torch.sum(valid)
    tol = inlier_threshold(points_w, valid)

    p0, p1, p2 = points_w[idx3[:, 0]], points_w[idx3[:, 1]], points_w[idx3[:, 2]]
    n = torch.linalg.cross(p1 - p0, p2 - p0)
    n_norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    degenerate = n_norm[:, 0] < 1e-9
    n = n / torch.clamp(n_norm, min=1e-12)

    # (H,N) point-plane distances
    d = torch.abs(torch.einsum("hj,nj->hn", n, points_w)
                  - torch.einsum("hj,hj->h", n, p0)[:, None])
    inl = (d < tol) & valid[None, :]
    score = torch.where(degenerate, -1, torch.sum(inl, -1))
    best = torch.argmax(score)       # the first index on ties
    inlier = inl[best]

    # refine: centroid and smallest-eigenvector normal of the inliers
    wi = inlier.to(points_w.dtype)
    swi = torch.clamp(torch.sum(wi), min=1.0)
    c = torch.sum(points_w * wi[:, None], 0) / swi
    dp = (points_w - c) * wi[:, None]
    cov = dp.T @ dp / swi + 1e-9 * torch.eye(3, device=points_w.device)
    _, eigvec = torch.linalg.eigh(cov)
    normal = eigvec[:, 0]            # the smallest eigenvalue's
    ok = (nv >= 10) & (score[best] >= torch.clamp(0.3 * nv, min=6))
    return c, normal, inlier, ok


def dominant_plane(points_w: torch.Tensor, valid: torch.Tensor,
                   generator: torch.Generator, n_hyp: int = 128):
    """Batched-RANSAC dominant plane -> (center, normal, inlier_mask, ok);
    see ``dominant_plane_from_triples``."""
    return dominant_plane_from_triples(points_w, valid,
                                       draw_triples(valid, generator, n_hyp))


def plane_align_from_plane(c, n, ok, up_hint=None):
    """The SE3 taking old world coordinates to a frame where the plane
    through ``c`` with normal ``n`` is z = 0, the identity unless ``ok``.
    ``up_hint`` (3,) in old world coordinates picks the normal's sign;
    default -z (the reference's ground-grid convention)."""
    dev = c.device
    hint = torch.tensor([0.0, 0.0, -1.0], device=dev) if up_hint is None else up_hint
    n = torch.where(torch.dot(n, hint) < 0, -n, n)
    # orthonormal basis (u, v, n): the rotation's rows are the new axes
    a = torch.where(torch.abs(n[0]) < 0.9, torch.tensor([1.0, 0.0, 0.0], device=dev),
                    torch.tensor([0.0, 1.0, 0.0], device=dev))
    u = torch.linalg.cross(n, a)
    u = u / torch.clamp(torch.linalg.vector_norm(u), min=1e-12)
    v = torch.linalg.cross(n, u)
    R = torch.stack([u, v, n])
    eye = SE3.identity(device=dev)
    return SE3(R=torch.where(ok, R, eye.R), t=torch.where(ok, -R @ c, eye.t))


def plane_align_transform(points_w: torch.Tensor, valid: torch.Tensor,
                          generator: torch.Generator, up_hint=None):
    """SE3 taking old world coordinates to a frame where the dominant plane
    is z = 0 -> (T_new_from_old, ok); the identity when no plane is found."""
    c, n, _, ok = dominant_plane(points_w, valid, generator)
    return plane_align_from_plane(c, n, ok, up_hint), ok


def apply_global_transform(ms: MapState, T: SE3) -> MapState:
    """w' = T.apply(w): move every point and re-hang every MKF base pose
    (base_from_world' = base_from_world @ T^-1), then refresh the points'
    world-frame pixel footprints (ApplyGlobalTransformationToMap).  Returns
    a new MapState; the leaves it does not change are shared with ``ms``."""
    Tinv = T.inv()
    base = ms.mkfs.base_from_world
    new_base = SE3(R=torch.einsum("mij,jk->mik", base.R, Tinv.R),
                   t=torch.einsum("mij,j->mi", base.R, Tinv.t) + base.t)
    ms = dataclasses.replace(
        ms, points=dataclasses.replace(ms.points, pos_w=T.apply(ms.points.pos_w)),
        mkfs=dataclasses.replace(ms.mkfs, base_from_world=new_base))
    return refresh_pixel_vectors(ms)


def apply_global_scale(ms: MapState, scale) -> MapState:
    """Uniform rescale about the world origin: point positions, MKF
    translations, scene depths and pixel footprints all scale
    (ApplyGlobalScaleToMap, src/System.cc:305-405).  Returns a new
    MapState sharing the unchanged leaves with ``ms``."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=ms.points.pos_w.device)
    pts = dataclasses.replace(ms.points, pos_w=ms.points.pos_w * s,
                              pixel_right_w=ms.points.pixel_right_w * s,
                              pixel_down_w=ms.points.pixel_down_w * s)
    base = ms.mkfs.base_from_world
    mkfs = dataclasses.replace(ms.mkfs, base_from_world=SE3(R=base.R, t=base.t * s),
                               scene_depth_mean=ms.mkfs.scene_depth_mean * s,
                               scene_depth_sigma=ms.mkfs.scene_depth_sigma * s)
    return dataclasses.replace(ms, points=pts, mkfs=mkfs)
