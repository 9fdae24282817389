"""Epipolar map-point creation: AddPointEpipolar (port of
mcptam_tpu/map/epipolar.py, ref src/MapMakerServerBase.cc:604-914).

For each candidate: the depth range on the source ray from the min/max
epipolar angles, the epipolar arc on the target camera's unit sphere
sampled at NH hypotheses, and at each hypothesis a warped template from
the source keyframe and a radius-3 ZMSSD corner search in the target
keyframe; then the ambiguity test, subpixel refinement of the best match
and midpoint triangulation.  The candidate x hypothesis product is one
pair axis of Q * NH entries.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from plainref.core.camera import (
    CameraModel, cam_sphere_deriv, project, projection_derivs_sphere, unproject,
)
from plainref.core.levels import level_zero_pos
from plainref.core.se3 import SE3
from plainref.map.builder import add_measurements, add_points
from plainref.map.state import SRC_EPIPOLAR, MapState, kf_cam_from_world
from plainref.ops.patch import (
    MAX_SSD, find_patch_w, make_warped_template_w, subpix_refine_w,
    warp_and_search_level,
)

N_HYPOTHESES = 32
MIN_EPI_ANGLE = 0.05
MAX_EPI_ANGLE = math.pi / 3


def auto_hypothesis_budget(cams: CameraModel, cam_from_base: SE3,
                           finest_level: int = 0, kf_baseline: float = 0.0,
                           buckets: tuple = (32, 64, 128)) -> int:
    """Rig-static arc-sampling budget approximating the reference's ~3 px
    arc stepping (src/MapMakerServerBase.cc:700-714): the smallest bucket
    that samples the longest camera-pair arc (at the central source ray)
    at <= 3 source-level px.  Host numpy, resolved once per rig."""
    C = int(cam_from_base.t.shape[0])
    scale = 2.0 ** finest_level

    def host(x):
        return x.detach().cpu().numpy().astype(np.float64)

    pairs = [(s, t, None) for s in range(C) for t in range(C) if s != t]
    if kf_baseline > 0.0:
        pairs += [(c, c, kf_baseline) for c in range(C)]
    needed = 1
    for s, t, shift in pairs:
        cam_s = cams[s]
        center = torch.stack([cam_s.center[0], cam_s.center[1]])
        ray_sc = host(unproject(cam_s, center))
        step_px = host(unproject(cam_s, center + torch.tensor(
            [scale, 0.0], device=center.device)))
        one_px = np.arccos(np.clip(np.dot(ray_sc, step_px / max(
            np.linalg.norm(step_px), 1e-12)), -1.0, 1.0))
        if one_px <= 1e-9:
            continue
        Rs, ts_ = host(cam_from_base.R[s]), host(cam_from_base.t[s])
        Rt, tt = host(cam_from_base.R[t]), host(cam_from_base.t[t])
        if shift is not None:
            tt = tt + np.array([shift, 0.0, 0.0])
        R_rel = Rt @ Rs.T
        t_rel = tt - R_rel @ ts_
        line_dir_tc = R_rel @ ray_sc
        cam_center_sc = Rs @ (-Rt.T @ tt) + ts_
        sep = np.linalg.norm(cam_center_sc)
        if sep <= 1e-6:
            continue
        src_angle = np.arccos(np.clip(np.dot(cam_center_sc, ray_sc) / sep, -1.0, 1.0))
        min_tgt = np.pi - src_angle - MAX_EPI_ANGLE
        start_depth = max(sep * np.sin(min_tgt) / np.sin(MAX_EPI_ANGLE), 0.2)
        max_tgt = np.pi - src_angle - MIN_EPI_ANGLE
        end_depth = max(sep * np.sin(max_tgt) / np.sin(MIN_EPI_ANGLE),
                        start_depth * 1.01)
        vA = t_rel + start_depth * line_dir_tc
        vB = t_rel + end_depth * line_dir_tc
        vA = vA / max(np.linalg.norm(vA), 1e-9)
        vB = vB / max(np.linalg.norm(vB), 1e-9)
        arc = np.arccos(np.clip(np.dot(vA, vB), -1.0, 1.0))
        needed = max(needed, int(np.ceil(arc / (3.0 * one_px))) + 1)
    for b in buckets:
        if needed <= b:
            return int(b)
    return int(buckets[-1])


def triangulate_midpoint(o1, d1, o2, d2):
    """World point closest to both rays (origin o, unit direction d)."""
    r = o2 - o1
    a = torch.sum(d1 * d1, -1)
    b = torch.sum(d1 * d2, -1)
    c = torch.sum(d2 * d2, -1)
    e = torch.sum(d1 * r, -1)
    f = torch.sum(d2 * r, -1)
    den = a * c - b * b
    small = torch.abs(den) < 1e-12
    den_safe = torch.where(small, torch.full_like(den, 1e-12), den)
    t1 = (c * e - b * f) / den_safe
    t2 = (b * e - a * f) / den_safe
    p1 = o1 + t1[..., None] * d1
    p2 = o2 + t2[..., None] * d2
    ok = (torch.abs(den) > 1e-12) & (t1 > 0) & (t2 > 0)
    return 0.5 * (p1 + p2), ok


def _norm(x, floor):
    return torch.clamp(torch.linalg.vector_norm(x, dim=-1), min=floor)


def epipolar_match(ms: MapState, cams: CameraModel, src_mkf, src_cam, tgt_mkf,
                   tgt_cam, level, xy_level, want, max_ssd: float = MAX_SSD,
                   n_hypotheses: int = N_HYPOTHESES,
                   corner_ambiguity: bool = False):
    """Batched epipolar matching of Q candidates ((Q,) indices, (Q,2)
    source-level coords).  Returns (ok, pos_w (Q,3), uv_tgt (Q,2) target
    subpixel position, target search level (Q,))."""
    NH = n_hypotheses
    Q = want.shape[0]
    dev = want.device
    f32 = torch.float32
    kcw = kf_cam_from_world(ms)
    sm, sc = src_mkf.long(), src_cam.long()
    tm, tc = tgt_mkf.long(), tgt_cam.long()
    cam_s, cam_t = cams[sc], cams[tc]
    pose_s = SE3(R=kcw.R[sm, sc], t=kcw.t[sm, sc])
    pose_t = SE3(R=kcw.R[tm, tc], t=kcw.t[tm, tc])

    lvl_f = level.to(f32)
    scale = torch.exp2(lvl_f)
    root = level_zero_pos(xy_level, lvl_f[:, None])
    ray_sc = unproject(cam_s, root)                          # (Q,3)
    rel_ts = pose_t @ pose_s.inv()                           # target <- source
    line_dir_tc = torch.einsum("qij,qj->qi", rel_ts.R, ray_sc)
    cam_center_tc = rel_ts.t
    cam_center_sc = (pose_s @ pose_t.inv()).t

    max_a = torch.tensor(MAX_EPI_ANGLE, dtype=f32, device=dev)
    min_a = torch.tensor(MIN_EPI_ANGLE, dtype=f32, device=dev)
    sep = torch.linalg.vector_norm(cam_center_sc, dim=-1)
    src_angle = torch.arccos(torch.clamp(
        torch.sum(cam_center_sc * ray_sc, -1) / torch.clamp(sep, min=1e-9), -1.0, 1.0))
    start_depth = torch.clamp(sep * torch.sin(math.pi - src_angle - max_a)
                              / torch.sin(max_a), min=0.2)
    end_depth = sep * torch.sin(math.pi - src_angle - min_a) / torch.sin(min_a)
    end_depth = torch.maximum(end_depth, start_depth * 1.01)

    ray_start_tc = cam_center_tc + start_depth[:, None] * line_dir_tc
    ray_end_tc = cam_center_tc + end_depth[:, None] * line_dir_tc
    vA = ray_start_tc / _norm(ray_start_tc, 1e-9)[:, None]
    vB = ray_end_tc / _norm(ray_end_tc, 1e-9)[:, None]
    arc_ok = torch.sum((vA - vB) ** 2, -1) > 1e-8
    normal = torch.linalg.cross(vA, vB)
    normal = normal / _norm(normal, 1e-9)[:, None]
    to_plane = torch.stack([vA, torch.linalg.cross(normal, vA), normal], 1)  # rows
    pB = torch.einsum("qij,qj->qi", to_plane, vB)
    max_angle = torch.arccos(torch.clamp(pB[:, 0], -1.0, 1.0))
    ray_start_p = torch.einsum("qij,qj->qi", to_plane, ray_start_tc)[:, :2]
    ray_end_p = torch.einsum("qij,qj->qi", to_plane, ray_end_tc)[:, :2]
    ray_dir_p = ray_end_p - ray_start_p
    ray_dir_p = ray_dir_p / _norm(ray_dir_p, 1e-9)[:, None]

    zero = torch.zeros_like(scale)
    right_nc = unproject(cam_s, root + torch.stack([scale, zero], -1))
    down_nc = unproject(cam_s, root + torch.stack([zero, scale], -1))

    # NH hypotheses uniformly over the arc
    angles = (torch.arange(NH, dtype=f32, device=dev) / (NH - 1.0)
              * max_angle[:, None])                          # (Q,NH)
    cx, sx = torch.cos(angles), torch.sin(angles)
    alpha_den = ray_dir_p[:, 1, None] * cx - ray_dir_p[:, 0, None] * sx
    alpha_den = torch.where(torch.abs(alpha_den) < 1e-12,
                            torch.full_like(alpha_den, 1e-12), alpha_den)
    alpha = (ray_start_p[:, 0, None] * sx - ray_start_p[:, 1, None] * cx) / alpha_den
    p_tc = ray_start_tc[:, None, :] + alpha[..., None] * line_dir_tc[:, None, :]
    p_w = pose_t.inv()[:, None].apply(p_tc)                  # (Q,NH,3)

    # hypothesis pixel vectors (RefreshPixelVectors inline, fronto-parallel)
    p_sc = pose_s[:, None].apply(p_w)
    cam_height = torch.abs(p_sc[..., 2])

    def on_plane(ray):
        rate = torch.clamp(torch.abs(ray[:, 2]), min=1e-9)
        return ray[:, None, :] * (cam_height / rate[:, None])[..., None]

    cen_pl = on_plane(ray_sc)
    Rt = pose_s.R.transpose(-1, -2)
    pix_right_w = torch.einsum("qij,qnj->qni", Rt, on_plane(right_nc) - cen_pl)
    pix_down_w = torch.einsum("qij,qnj->qni", Rt, on_plane(down_nc) - cen_pl)

    cam_tn = cams[tc[:, None]]
    uv_t, proj_ok = project(cam_tn, p_tc)                    # (Q,NH)
    duv = projection_derivs_sphere(cam_tn, p_tc)
    d_th, d_ph = cam_sphere_deriv(p_tc)
    warp, hyp_lvl, w_ok = warp_and_search_level(
        duv, d_th, d_ph, pose_t.R[:, None], pix_right_w, pix_down_w)

    # every (candidate, hypothesis) pair at once
    def rep(x):
        return x.repeat_interleave(NH, 0)

    P = Q * NH
    hl = hyp_lvl.reshape(P)
    tmpl, t_ok = make_warped_template_w(
        ms.mkfs.atlas, rep(sm), rep(sc), rep(level.long()),
        rep(xy_level.to(f32)), warp.reshape(P, 2, 2), hl)
    found, hpos, hssd = find_patch_w(
        ms.mkfs.atlas, ms.mkfs.corner_atlas, rep(tm), rep(tc), hl, tmpl,
        uv_t.reshape(P, 2), 3, max_ssd=max_ssd)
    hyp_ok = (found & proj_ok.reshape(P) & w_ok.reshape(P) & t_ok).reshape(Q, NH)
    hyp_ssd = torch.where(hyp_ok, hssd.reshape(Q, NH),
                          torch.full((Q, NH), float("inf"), device=dev))
    hyp_pos = hpos.reshape(Q, NH, 2)
    hyp_tmpl = tmpl.reshape(Q, NH, 8, 8)

    best_ssd, best = torch.min(hyp_ssd, 1)                  # first minimum
    ar = torch.arange(Q, device=dev)
    any_found = torch.isfinite(best_ssd)
    best_lvl = hyp_lvl[ar, best]
    # ambiguity (ref :798-825): every match within 10% of the best must
    # sit near it, few in number (see the reference for the two rules)
    one_px_lvl_angle = torch.arccos(torch.clamp(
        torch.sum(ray_sc * right_nc, -1) / _norm(right_nc, 1e-12), -1.0, 1.0))
    step = max_angle / (NH - 1.0)
    close = hyp_ok & (hyp_ssd <= best_ssd[:, None] * 1.1 + 1e-6)
    d_ang = torch.abs(angles - angles[ar, best][:, None])
    if corner_ambiguity:
        pos_l0 = level_zero_pos(hyp_pos, hyp_lvl.to(f32)[..., None])
        d_corner = torch.amax(torch.abs(pos_l0 - pos_l0[ar, best][:, None]), -1)
        same_corner = d_corner <= 2.0 * torch.exp2(best_lvl.to(f32))[:, None]
        rival = close & ~same_corner
        lvl_gap = torch.clamp(torch.exp2(best_lvl.to(f32) - lvl_f), min=1.0)
        overlap = 3.0 * one_px_lvl_angle * lvl_gap + step
        depth_wide = close & same_corner & (d_ang > (overlap * (1.0 + 1e-5))[:, None])
        unambiguous = (torch.sum(rival, -1) == 0) & (torch.sum(depth_wide, -1) == 0)
    else:
        window = torch.minimum(step, 3.0 * one_px_lvl_angle)
        far_close = close & (d_ang > (window * (1.0 + 1e-5))[:, None])
        unambiguous = (torch.sum(far_close, -1) == 0) & (torch.sum(close, -1) <= 3)

    pos_sub, conv = subpix_refine_w(ms.mkfs.atlas, tm, tc, best_lvl,
                                    hyp_tmpl[ar, best], hyp_pos[ar, best], 10)

    # triangulate the source root ray against the refined target ray
    ray_t = unproject(cam_t, pos_sub)
    inv_s, inv_t = pose_s.inv(), pose_t.inv()
    pos_w, tri_ok = triangulate_midpoint(
        inv_s.t, torch.einsum("qij,qj->qi", inv_s.R, ray_sc),
        inv_t.t, torch.einsum("qij,qj->qi", inv_t.R, ray_t))
    ok = want & arc_ok & any_found & unambiguous & conv & tri_ok & (sep > 1e-6)
    return ok, pos_w, pos_sub, best_lvl


def create_epipolar_points(ms: MapState, cams: CameraModel, src_mkf, src_cam,
                           tgt_mkf, tgt_cam, level, xy_level, want,
                           max_ssd: float = MAX_SSD,
                           n_hypotheses: int = N_HYPOTHESES,
                           corner_ambiguity: bool = False):
    """Match, then commit each successful candidate as a point with a ROOT
    (source) and an EPIPOLAR (target) measurement.  Updates ms; returns
    (ms, created (Q,))."""
    ok, pos_w, uv_tgt, _ = epipolar_match(
        ms, cams, src_mkf, src_cam, tgt_mkf, tgt_cam, level, xy_level, want,
        max_ssd, n_hypotheses, corner_ambiguity)
    ms, slots, created = add_points(ms, cams, mkf_idx=src_mkf, cam_idx=src_cam,
                                    level=level, xy_level=xy_level.to(torch.float32),
                                    pos_w=pos_w, want=ok)
    Q = want.shape[0]
    ms = add_measurements(
        ms, mkf=tgt_mkf, cam=tgt_cam, point=slots, level=level, uv_l0=uv_tgt,
        want=created,
        source=torch.full((Q,), SRC_EPIPOLAR, dtype=torch.int32, device=want.device),
        subpix=torch.ones(Q, dtype=torch.bool, device=want.device))
    return ms, created
