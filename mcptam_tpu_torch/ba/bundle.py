"""Levenberg-Marquardt bundle adjustment with Schur elimination (port of
mcptam_tpu/ba/bundle.py, ref ChainBundle src/ChainBundle.cc:976-1451).

The port carries the reference's production layout: measurements grouped
by point in an (L, D) observation table (``attach_obs_table``), every
per-measurement quantity a flat tensor (the SoA path), the reduced camera
system assembled with a few (rows, N) x (N, P) products and solved by the
hand-written Cholesky kernel (``core/spd.spd_solve``) once per LM step.
``lm_run`` is a Python loop carrying the current chi2 as the reference's
scan does; it reads nothing back to the host.

Problems built by hand without an observation table (the extrinsic
calibration's, calib/extrinsic.py) take the scatter path: the normal
equations accumulated per measurement (``_normal_system``) and the reduced
system solved with ``torch.linalg.solve`` (``_solve_delta``), as the JAX
package solves that path with ``jnp.linalg.solve``.

Both paths take an optional process group (parallel/mesh.py).  On the
observation-table path each rank then holds a block of the points with
their table rows (``shard_bundle_problem_soa``): the pose blocks, the Schur
correction, the median's counts and every cost and count are summed over
the ranks, each rank solves the same reduced system and back-substitutes
its own points.  On the scatter path each rank holds a block of the
measurements (``shard_bundle_problem``): the normal equations, the
median's counts, the costs and counts are summed, and the solve is the
same on every rank.  With no group nothing is reduced.

Each LM iteration runs inside spans (system/timing.py): ``ba.lm_step``
around it, ``ba.robust`` (median, weights, cost), ``ba.schur`` (the solve
by Schur complement; ``ba.resid_jac`` and ``ba.solve``, the ``spd_solve``
call, inside it on the SoA path), ``ba.trial`` (the updated estimate's
residuals and cost) and ``ba.update`` (accept or reject).
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass

import torch

from mcptam_tpu_torch.config import DEFAULT_BUNDLE, BundleConfig
from mcptam_tpu_torch.core import mest
from mcptam_tpu_torch.core.camera import (
    CameraModel, cam_sphere_deriv, camera_soa, project, project_chain_soa,
    projection_derivs_sphere,
)
from mcptam_tpu_torch.core.linalg import inv3
from mcptam_tpu_torch.core.se3 import SE3
from mcptam_tpu_torch.core.spd import spd_solve
from mcptam_tpu_torch.parallel.collectives import all_reduce
from mcptam_tpu_torch.system.timing import span

# the host-side index of an LM iteration, the id of its spans
_STEP_IDS = itertools.count()

@dataclass
class BundleProblem:
    """Static-capacity bundle problem: measurement k observes point
    m_point[k] through the chain world --pose_a--> base --pose_b--> camera."""

    pose_a: SE3               # (Pa,) X-from-world
    pose_b: SE3               # (Pb,) cam-from-X
    movable_a: torch.Tensor   # (Pa,) bool
    movable_b: torch.Tensor   # (Pb,) bool
    points: torch.Tensor      # (L,3)
    movable_pt: torch.Tensor  # (L,) bool
    m_pose_a: torch.Tensor    # (K,) int32
    m_pose_b: torch.Tensor    # (K,) int32
    m_point: torch.Tensor     # (K,) int32
    m_cam: torch.Tensor       # (K,) int32 camera-model index
    m_uv: torch.Tensor        # (K,2) measured level-0 position
    m_level: torch.Tensor     # (K,)
    m_valid: torch.Tensor     # (K,) bool
    pt_src_a: torch.Tensor = None    # (L,) source-KF chain of each point
    pt_src_b: torch.Tensor = None
    pt_index: torch.Tensor = None    # (L,) original point ids (compacted)
    pt_index_ok: torch.Tensor = None
    m_index: torch.Tensor = None     # (K,) original measurement ids
    m_index_ok: torch.Tensor = None
    obs_idx: torch.Tensor = None     # (L,D) int32 into the meas arrays
    obs_valid: torch.Tensor = None   # (L,D) bool
    obs_dropped: torch.Tensor = None  # () int32 beyond a point's D slots

    def replace(self, **kw) -> "BundleProblem":
        return dataclasses.replace(self, **kw)


@dataclass
class LMState:
    pose_a: SE3
    pose_b: SE3
    points: torch.Tensor
    lam: torch.Tensor         # LM lambda
    cost: torch.Tensor        # robustified cost at the current estimate
    sigma_sq: torch.Tensor    # robust sigma^2 (level-scaled px^2)
    converged: torch.Tensor   # () bool
    accepted: torch.Tensor    # () int32
    iterations: torch.Tensor  # () int32
    max_update: torch.Tensor  # last accepted update RMS


def attach_obs_table(prob: BundleProblem, D: int) -> BundleProblem:
    """Group measurements by point into an (L, D) index table; a point with
    more than D valid measurements keeps D of them in the normal equations
    and the rest are counted in ``obs_dropped``."""
    L = prob.points.shape[0]
    K = prob.m_valid.shape[0]
    dev = prob.m_valid.device
    BIG = L + 1
    key = torch.where(prob.m_valid, prob.m_point.long(), torch.full_like(prob.m_point.long(), BIG))
    order = torch.argsort(key, stable=True)               # valid grouped
    s = key[order]
    first = torch.searchsorted(s, s, side="left")
    rank = torch.arange(K, device=dev) - first
    ok = (s < BIG) & (rank < D)
    slot = torch.where(ok, s * D + rank, torch.full_like(s, L * D))
    idx = torch.full((L * D + 1,), K, dtype=torch.int32, device=dev)
    idx[slot] = order.to(torch.int32)                     # dump slot L*D
    idx = idx[: L * D].reshape(L, D)
    dropped = torch.sum((s < BIG) & (rank >= D)).to(torch.int32)
    return prob.replace(obs_idx=idx, obs_valid=idx < K, obs_dropped=dropped)


def max_obs_per_point(prob: BundleProblem) -> torch.Tensor:
    """Largest per-point valid-measurement count: the D that drops nothing."""
    L = prob.points.shape[0]
    counts = torch.zeros(L, dtype=torch.int32, device=prob.m_valid.device)
    counts.index_add_(0, prob.m_point.long(), prob.m_valid.to(torch.int32))
    return torch.max(counts)


def _pad_tail(x: torch.Tensor) -> torch.Tensor:
    """Append one zero row so index K addresses a null measurement."""
    return torch.cat([x, torch.zeros((1,) + tuple(x.shape[1:]), dtype=x.dtype,
                                     device=x.device)], 0)


def _gens(p: torch.Tensor) -> torch.Tensor:
    """(K,3) points -> (K,6,3) d p / d [translation, rotation]."""
    K = p.shape[0]
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(K, 3, 3)
    z = torch.zeros(K, dtype=p.dtype, device=p.device)
    px, py, pz = p[:, 0], p[:, 1], p[:, 2]
    rot = torch.stack([
        torch.stack([z, -pz, py], -1),
        torch.stack([pz, z, -px], -1),
        torch.stack([-py, px, z], -1),
    ], 1)
    return torch.cat([eye, rot], 1)


def _residuals_and_jacobians(prob: BundleProblem, pose_a: SE3, pose_b: SE3,
                             points, cams: CameraModel):
    """Per-measurement residuals (level-scaled) and Jacobians wrt pose_a
    (6), pose_b (6), point (3), AoS layout."""
    ia, ib = prob.m_pose_a.long(), prob.m_pose_b.long()
    pa, pb = pose_a[ia], pose_b[ib]
    pt = points[prob.m_point.long()]
    cam = cams[prob.m_cam.long()]

    p_base = pa.apply(pt)
    p_cam = pb.apply(p_base)
    uv_hat, proj_ok = project(cam, p_cam)
    duv2 = projection_derivs_sphere(cam, p_cam)        # (K,2,2)
    d_th, d_ph = cam_sphere_deriv(p_cam)               # (K,3)
    duv = torch.einsum("kij,kjl->kil", duv2, torch.stack([d_th, d_ph], -2))

    dcam_a = torch.einsum("kij,kgj->kgi", pb.R, _gens(p_base))
    dcam_b = _gens(p_cam)
    Ja = torch.einsum("kil,kgl->kig", duv, dcam_a)     # (K,2,6)
    Jb = torch.einsum("kil,kgl->kig", duv, dcam_b)
    Rba = torch.einsum("kij,kjl->kil", pb.R, pa.R)
    Jl = torch.einsum("kil,klm->kim", duv, Rba)        # (K,2,3)

    inv_scale = 1.0 / torch.exp2(prob.m_level.to(torch.float32))
    e = (prob.m_uv - uv_hat) * inv_scale[:, None]

    def fin(x):
        return torch.isfinite(x).flatten(1).all(-1)

    ok = (prob.m_valid & proj_ok & fin(e) & fin(Ja) & fin(Jb) & fin(Jl))
    e = torch.where(ok[:, None], e, torch.zeros_like(e))

    def z(x):
        return torch.where(ok[:, None, None], x, torch.zeros_like(x))

    Ja = z(Ja) * prob.movable_a[ia].to(Ja.dtype)[:, None, None]
    Jb = z(Jb) * prob.movable_b[ib].to(Jb.dtype)[:, None, None]
    Jl = z(Jl) * prob.movable_pt[prob.m_point.long()].to(Jl.dtype)[:, None, None]
    s = inv_scale[:, None, None]
    return e, Ja * s, Jb * s, Jl * s, ok


def _robust(e, ok, bcfg: BundleConfig, group=None):
    """Adaptive Huber: sigma^2 = max(median chi2, min_sigma^2)
    (RobustKernelAdaptive, src/ChainBundle.cc:871-901); the median and the
    cost over the measurements of every rank of ``group``."""
    chi2 = torch.sum(e * e, -1)
    med = mest.masked_median_hist(chi2, ok, group=group)
    sigma_sq = torch.clamp(med, min=bcfg.min_sigma_px ** 2)
    w = mest.weight(mest.HUBER, chi2, sigma_sq) * ok
    cost = all_reduce(torch.sum(mest.objective_score(mest.HUBER, chi2, sigma_sq) * ok),
                      group)
    return w, cost, sigma_sq


def _assemble_grouped(prob: BundleProblem, e, Ja, Jb, Jl, w):
    """Normal equations through the (L, D) observation table, as dense
    products.  Returns (Hpp (6P,6P), b_p (6P,), V (L,3,3), b_l (L,3),
    Wl (L,6P,3))."""
    Pa = prob.movable_a.shape[0]
    P = Pa + prob.movable_b.shape[0]
    L, D = prob.obs_idx.shape
    idx = prob.obs_idx.long()
    q = torch.sqrt(torch.clamp(_pad_tail(w)[idx], min=0.0)) * prob.obs_valid
    eq = _pad_tail(e)[idx] * q[..., None]                   # (L,D,2)
    Jlq = _pad_tail(Jl)[idx] * q[..., None, None]           # (L,D,2,3)
    Jaq = _pad_tail(Ja)[idx] * q[..., None, None]           # (L,D,2,6)
    Jbq = _pad_tail(Jb)[idx] * q[..., None, None]
    ga = _pad_tail(prob.m_pose_a).long()[idx]
    gb = Pa + _pad_tail(prob.m_pose_b).long()[idx]
    oha = torch.nn.functional.one_hot(ga, P).to(Jaq.dtype)  # (L,D,P)
    ohb = torch.nn.functional.one_hot(gb, P).to(Jaq.dtype)
    F = (torch.einsum("ldp,ldiv->ldipv", oha, Jaq)
         + torch.einsum("ldp,ldiv->ldipv", ohb, Jbq)).reshape(L, D, 2, 6 * P)
    Hf = torch.einsum("ldix,ldiy->xy", F, F)
    b_p = torch.einsum("ldix,ldi->x", F, eq)
    V = torch.einsum("ldiv,ldiw->lvw", Jlq, Jlq)
    b_l = torch.einsum("ldiv,ldi->lv", Jlq, eq)
    Wl = torch.einsum("ldix,ldiw->lxw", F, Jlq)
    return Hf, b_p, V, b_l, Wl


def _normal_system(prob: BundleProblem, e, Ja, Jb, Jl, w, group=None):
    """The undamped normal equations accumulated per measurement: pose-pose
    blocks Hpp (P,P,6,6) with the (a,b) cross blocks a measurement's two
    chain poses share, b_p (P,6), the point diagonal V (L,3,3), b_l (L,3)
    and the pose-point blocks W (P,L,6,3); each a full-size partial over
    this rank's measurements, summed over the ranks of ``group``."""
    Pa = prob.movable_a.shape[0]
    P = Pa + prob.movable_b.shape[0]
    L = prob.points.shape[0]
    dt, dev = e.dtype, e.device
    ga = prob.m_pose_a.long()
    gb = Pa + prob.m_pose_b.long()
    gpose = torch.cat([ga, gb])
    Jp2 = torch.cat([Ja, Jb], 0)                            # (2K,2,6)
    e2 = torch.cat([e, e], 0)
    w2 = torch.cat([w, w], 0)
    pt = prob.m_point.long()
    pt2 = torch.cat([pt, pt])

    Hpp = torch.zeros((P, P, 6, 6), dtype=dt, device=dev)
    Hpp.index_put_((gpose, gpose), torch.einsum("k,kiv,kiw->kvw", w2, Jp2, Jp2),
                   accumulate=True)
    Hab = torch.einsum("k,kiv,kiw->kvw", w, Ja, Jb)
    Hpp.index_put_((ga, gb), Hab, accumulate=True)
    Hpp.index_put_((gb, ga), Hab.transpose(-1, -2), accumulate=True)
    b_p = torch.zeros((P, 6), dtype=dt, device=dev).index_add_(
        0, gpose, torch.einsum("k,kiv,ki->kv", w2, Jp2, e2))
    V = torch.zeros((L, 3, 3), dtype=dt, device=dev).index_add_(
        0, pt, torch.einsum("k,kiv,kiw->kvw", w, Jl, Jl))
    b_l = torch.zeros((L, 3), dtype=dt, device=dev).index_add_(
        0, pt, torch.einsum("k,kiv,ki->kv", w, Jl, e))
    W = torch.zeros((P, L, 6, 3), dtype=dt, device=dev)
    W.index_put_((gpose, pt2), torch.einsum("k,kiv,kiw->kvw", w2, Jp2,
                                            torch.cat([Jl, Jl], 0)), accumulate=True)
    return tuple(all_reduce(x, group) for x in (Hpp, b_p, V, b_l, W))


def _assemble_flat(prob: BundleProblem, e, Ja, Jb, Jl, w, group=None):
    """Flat-space normal equations from either layout: through the
    observation table when one is attached, else accumulated per
    measurement (over every rank of ``group``).  Returns (Hpp (6P,6P),
    b_p (6P,), V (L,3,3), b_l (L,3), Wl (L,6P,3))."""
    if prob.obs_idx is not None:
        return _assemble_grouped(prob, e, Ja, Jb, Jl, w)
    P = prob.movable_a.shape[0] + prob.movable_b.shape[0]
    Hpp, b_p, V, b_l, W = _normal_system(prob, e, Ja, Jb, Jl, w, group)
    Hf = Hpp.permute(0, 2, 1, 3).reshape(6 * P, 6 * P)
    Wl = W.permute(1, 0, 2, 3).reshape(-1, 6 * P, 3)
    return Hf, b_p.reshape(-1), V, b_l, Wl


def _solve_delta(prob: BundleProblem, e, Ja, Jb, Jl, w, lam, group=None):
    """One damped Gauss-Newton solve by Schur complement, either layout.
    Returns (delta_a (Pa,6), delta_b (Pb,6), delta_pt (L,3))."""
    Pa = prob.movable_a.shape[0]
    P = Pa + prob.movable_b.shape[0]
    Hf, b_p, V, b_l, Wl = _assemble_flat(prob, e, Ja, Jb, Jl, w, group)
    eye3 = torch.eye(3, dtype=V.dtype, device=V.device)
    Hf = Hf + torch.diag(lam * torch.diagonal(Hf) + 1e-8)
    Vd = V + lam * (V * eye3) + 1e-8 * eye3
    Vinv = inv3(Vd) * prob.movable_pt[:, None, None]
    T = torch.einsum("lxw,lwy->lxy", Wl, Vinv)              # (L,6P,3)
    S = Hf - torch.einsum("lxy,lzy->xz", T, Wl)
    b_s = b_p - torch.einsum("lxy,ly->x", T, b_l)
    movable = torch.cat([prob.movable_a, prob.movable_b])
    mvec = movable.repeat_interleave(6).to(torch.float32)
    Sf = S * mvec[:, None] * mvec[None, :] + torch.diag(1.0 - mvec)
    with span("ba.solve"):
        delta_f = torch.linalg.solve(Sf, b_s * mvec) * mvec
    delta_p = delta_f.reshape(P, 6) * movable[:, None]
    rhs = b_l - torch.einsum("lxw,x->lw", Wl, delta_f)
    delta_l = torch.einsum("lxy,ly->lx", Vinv, rhs)
    return delta_p[:Pa], delta_p[Pa:], delta_l


# ---------------------------------------------------------------------------
# SoA fast path
# ---------------------------------------------------------------------------

def _soa_prep(prob: BundleProblem) -> dict:
    """Per-problem constants of the SoA step, computed once per lm_run."""
    L, D = prob.obs_idx.shape
    idx = prob.obs_idx.reshape(-1).long()                   # (N,)
    ia = _pad_tail(prob.m_pose_a)[idx].long()
    ib = _pad_tail(prob.m_pose_b)[idx].long()
    icam = _pad_tail(prob.m_cam)[idx].long()
    Pa = prob.movable_a.shape[0]
    Pb = prob.movable_b.shape[0]
    oha = torch.nn.functional.one_hot(ia.reshape(L, D), Pa).to(torch.float32)
    ohb = torch.nn.functional.one_hot(ib.reshape(L, D), Pb).to(torch.float32)
    return {"idx": idx, "ia": ia, "ib": ib, "icam": icam, "oha": oha, "ohb": ohb}


def _chain(pose_a: SE3, pose_b: SE3, points, ia, ib, ipt):
    """Component lists of R_a, t_a, R_b, t_b and the base- and camera-frame
    points for index vectors ia, ib, ipt."""
    Ra = [[pose_a.R[:, i, j][ia] for j in range(3)] for i in range(3)]
    ta = [pose_a.t[:, i][ia] for i in range(3)]
    Rb = [[pose_b.R[:, i, j][ib] for j in range(3)] for i in range(3)]
    tb = [pose_b.t[:, i][ib] for i in range(3)]
    pt = [points[:, i][ipt] for i in range(3)]
    pb_ = [ta[i] + Ra[i][0] * pt[0] + Ra[i][1] * pt[1] + Ra[i][2] * pt[2]
           for i in range(3)]
    pc_ = [tb[i] + Rb[i][0] * pb_[0] + Rb[i][1] * pb_[1] + Rb[i][2] * pb_[2]
           for i in range(3)]
    return Ra, Rb, pb_, pc_


def _resid_chi2_soa(prob: BundleProblem, pose_a: SE3, pose_b: SE3,
                    points, cams: CameraModel):
    """Residual-only pass over all K measurements.  Returns (chi2 (K,),
    ok (K,)) with chi2 zeroed where ~ok."""
    _, _, _, pc_ = _chain(pose_a, pose_b, points, prob.m_pose_a.long(),
                          prob.m_pose_b.long(), prob.m_point.long())
    ch = project_chain_soa(camera_soa(cams, prob.m_cam), pc_[0], pc_[1], pc_[2],
                           with_derivs=False)
    inv_scale = 1.0 / torch.exp2(prob.m_level.to(torch.float32))
    e0 = (prob.m_uv[:, 0] - ch["u"]) * inv_scale
    e1 = (prob.m_uv[:, 1] - ch["v"]) * inv_scale
    ok = prob.m_valid & ch["ok"] & torch.isfinite(e0) & torch.isfinite(e1)
    chi2 = torch.where(ok, e0 * e0 + e1 * e1, torch.zeros_like(e0))
    return chi2, ok


def _resid_jac_soa(prob: BundleProblem, pose_a: SE3, pose_b: SE3, points,
                   cams: CameraModel, pr: dict, with_b: bool = True):
    """Residuals and analytic Jacobians at the observation-table entries.
    Returns (e [2], Ja [2][6], Jb [2][6] or None, Jl [2][3], ok (N,)),
    zeroed where ~ok, level-scaled, movable masks folded in."""
    idx, ia, ib = pr["idx"], pr["ia"], pr["ib"]
    L, D = prob.obs_idx.shape
    ipt = torch.arange(L, device=idx.device).repeat_interleave(D)
    Ra, Rb, pb_, pc_ = _chain(pose_a, pose_b, points, ia, ib, ipt)

    ch = project_chain_soa(camera_soa(cams, pr["icam"]), pc_[0], pc_[1], pc_[2],
                           with_derivs=True)
    duv = ch["duv"]                                         # [2][3] (N,)
    zero = torch.zeros_like(pc_[0])

    def skew_rows(p):
        return [[zero, -p[2], p[1]], [p[2], zero, -p[0]], [-p[1], p[0], zero]]

    rot_a = skew_rows(pb_)
    dcam_a = [[Rb[i][g] for i in range(3)] for g in range(3)] + [
        [Rb[i][0] * rot_a[r][0] + Rb[i][1] * rot_a[r][1] + Rb[i][2] * rot_a[r][2]
         for i in range(3)]
        for r in range(3)
    ]
    Rba = [[Rb[i][0] * Ra[0][m] + Rb[i][1] * Ra[1][m] + Rb[i][2] * Ra[2][m]
            for m in range(3)] for i in range(3)]
    Ja = [[duv[i][0] * dcam_a[g][0] + duv[i][1] * dcam_a[g][1]
           + duv[i][2] * dcam_a[g][2] for g in range(6)] for i in range(2)]
    Jl = [[duv[i][0] * Rba[0][m] + duv[i][1] * Rba[1][m] + duv[i][2] * Rba[2][m]
           for m in range(3)] for i in range(2)]
    if with_b:
        rot_b = skew_rows(pc_)
        eye = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
        dcam_b = [[torch.full_like(zero, eye[g][i]) for i in range(3)]
                  for g in range(3)] + [[rot_b[r][i] for i in range(3)]
                                        for r in range(3)]
        Jb = [[duv[i][0] * dcam_b[g][0] + duv[i][1] * dcam_b[g][1]
               + duv[i][2] * dcam_b[g][2] for g in range(6)] for i in range(2)]
    else:
        Jb = None

    inv_scale = 1.0 / torch.exp2(_pad_tail(prob.m_level)[idx].to(torch.float32))
    e = [(_pad_tail(prob.m_uv[:, 0])[idx] - ch["u"]) * inv_scale,
         (_pad_tail(prob.m_uv[:, 1])[idx] - ch["v"]) * inv_scale]

    ok = _pad_tail(prob.m_valid)[idx] & ch["ok"]
    for i in range(2):
        ok = ok & torch.isfinite(e[i])
        for g in range(6):
            ok = ok & torch.isfinite(Ja[i][g])
            if with_b:
                ok = ok & torch.isfinite(Jb[i][g])
        for m in range(3):
            ok = ok & torch.isfinite(Jl[i][m])

    mva = prob.movable_a.to(torch.float32)[ia] * inv_scale
    mvl = prob.movable_pt.to(torch.float32)[ipt] * inv_scale

    def z(x):
        return torch.where(ok, x, zero)

    e = [z(x) for x in e]
    Ja = [[z(Ja[i][g]) * mva for g in range(6)] for i in range(2)]
    if with_b:
        mvb = prob.movable_b.to(torch.float32)[ib] * inv_scale
        Jb = [[z(Jb[i][g]) * mvb for g in range(6)] for i in range(2)]
    Jl = [[z(Jl[i][m]) * mvl for m in range(3)] for i in range(2)]
    return e, Ja, Jb, Jl, ok


def _inv3_soa(v00, v01, v02, v11, v12, v22):
    """Closed-form symmetric 3x3 inverse on component tensors."""
    c00 = v11 * v22 - v12 * v12
    c01 = v02 * v12 - v01 * v22
    c02 = v01 * v12 - v02 * v11
    c11 = v00 * v22 - v02 * v02
    c12 = v01 * v02 - v00 * v12
    c22 = v00 * v11 - v01 * v01
    det = v00 * c00 + v01 * c01 + v02 * c02
    inv_det = 1.0 / torch.where(det == 0, torch.ones_like(det), det)
    return (c00 * inv_det, c01 * inv_det, c02 * inv_det,
            c11 * inv_det, c12 * inv_det, c22 * inv_det)


_PAIRS = [(v, wc) for v in range(6) for wc in range(v, 6)]  # 21


def _sym_blocks(rows21: torch.Tensor, Pn: int) -> torch.Tensor:
    """(21, Pn) upper-triangle rows -> (Pn,6,6) symmetric blocks."""
    Hb = torch.zeros((6, 6, Pn), dtype=rows21.dtype, device=rows21.device)
    for k, (v, wc) in enumerate(_PAIRS):
        Hb[v, wc] = rows21[k]
        if v != wc:
            Hb[wc, v] = rows21[k]
    return Hb.permute(2, 0, 1)


def _block_diag(Hbl: torch.Tensor) -> torch.Tensor:
    """(Pn,6,6) -> (Pn,6,Pn,6) with the blocks on the pose diagonal."""
    Pn = Hbl.shape[0]
    out = torch.zeros((Pn, 6, Pn, 6), dtype=Hbl.dtype, device=Hbl.device)
    j = torch.arange(Pn, device=Hbl.device)
    out[j, :, j, :] = Hbl
    return out


def _solve_delta_soa(prob: BundleProblem, pr: dict, pose_a: SE3, pose_b: SE3,
                     points, cams: CameraModel, w, lam, fixed_b: bool = False,
                     group=None):
    """One damped Gauss-Newton solve by Schur complement, SoA layout.
    fixed_b=True declares every pose_b fixed (the map-maker's BA): the
    pose-b system drops out and the reduced system is 6 Pa wide.  With a
    ``group`` the pose blocks and the Schur correction are summed over the
    ranks' points; the points' own rows stay on their rank."""
    L, D = prob.obs_idx.shape
    Pa = prob.movable_a.shape[0]
    Pb = prob.movable_b.shape[0]
    P = Pa + Pb

    with span("ba.resid_jac"):
        e, Ja, Jb, Jl, okN = _resid_jac_soa(prob, pose_a, pose_b, points, cams, pr,
                                            with_b=not fixed_b)
    q = torch.sqrt(torch.clamp(_pad_tail(w)[pr["idx"]], min=0.0)) * okN
    A = [[q * Ja[i][g] for g in range(6)] for i in range(2)]
    B = None if fixed_b else [[q * Jb[i][g] for g in range(6)] for i in range(2)]
    Pt = [[q * Jl[i][m] for m in range(3)] for i in range(2)]
    eq = [q * e[0], q * e[1]]

    def gram(X, v, wc):
        return X[0][v] * X[0][wc] + X[1][v] * X[1][wc]

    rows_a = [gram(A, v, wc) for v, wc in _PAIRS]
    rows_a += [A[0][v] * eq[0] + A[1][v] * eq[1] for v in range(6)]
    if not fixed_b:
        hab = [[A[0][v] * B[0][wc] + A[1][v] * B[1][wc] for wc in range(6)]
               for v in range(6)]
        for c in range(Pb):
            mask_c = (pr["ib"] == c).to(torch.float32)
            rows_a += [hab[v][wc] * mask_c for v in range(6) for wc in range(6)]
    Ma = all_reduce(torch.stack(rows_a, 0) @ pr["oha"].reshape(-1, Pa), group)
    if not fixed_b:
        rows_b = [gram(B, v, wc) for v, wc in _PAIRS]
        rows_b += [B[0][v] * eq[0] + B[1][v] * eq[1] for v in range(6)]
        Mb = all_reduce(torch.stack(rows_b, 0) @ pr["ohb"].reshape(-1, Pb), group)

    b_pa = Ma[21:27].T                                     # (Pa,6)
    TL = _block_diag(_sym_blocks(Ma[:21], Pa))
    if fixed_b:
        PS = Pa
        Hf = TL.reshape(6 * Pa, 6 * Pa)
        b_p = b_pa.reshape(-1)
        movable = prob.movable_a
    else:
        PS = P
        b_pb = Mb[21:27].T
        Hab = Ma[27:].reshape(Pb, 6, 6, Pa).permute(3, 1, 0, 2)  # (Pa,6,Pb,6)
        BR = _block_diag(_sym_blocks(Mb[:21], Pb))
        top = torch.cat([TL, Hab], 2)
        bot = torch.cat([Hab.permute(2, 3, 0, 1), BR], 2)
        Hf = torch.cat([top, bot], 0).reshape(6 * P, 6 * P)
        b_p = torch.cat([b_pa, b_pb], 0).reshape(-1)
        movable = torch.cat([prob.movable_a, prob.movable_b])

    # point side
    def dsum(x):
        return x.reshape(L, D).sum(1)

    V6 = [dsum(gram(Pt, v, wc)) for v, wc in
          [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]]
    b_l = [dsum(Pt[0][m] * eq[0] + Pt[1][m] * eq[1]) for m in range(3)]
    scale = 1.0 + lam
    mvp = prob.movable_pt.to(torch.float32)
    Vi = _inv3_soa(V6[0] * scale + 1e-8, V6[1], V6[2], V6[3] * scale + 1e-8,
                   V6[4], V6[5] * scale + 1e-8)
    Vinv = [[Vi[0] * mvp, Vi[1] * mvp, Vi[2] * mvp],
            [Vi[1] * mvp, Vi[3] * mvp, Vi[4] * mvp],
            [Vi[2] * mvp, Vi[4] * mvp, Vi[5] * mvp]]

    # cross blocks W: per-observation 6x3 products, summed per point
    # against the one-hot pose table
    Xa = torch.stack([A[0][v] * Pt[0][m] + A[1][v] * Pt[1][m]
                      for v in range(6) for m in range(3)], -1).reshape(L, D, 18)
    Wcat = torch.bmm(pr["oha"].transpose(1, 2), Xa)       # (L,Pa,18)
    if not fixed_b:
        Xb = torch.stack([B[0][v] * Pt[0][m] + B[1][v] * Pt[1][m]
                          for v in range(6) for m in range(3)], -1).reshape(L, D, 18)
        Wcat = torch.cat([Wcat, torch.bmm(pr["ohb"].transpose(1, 2), Xb)], 1)
    W = [Wcat[:, :, m::3].reshape(L, 6 * PS) for m in range(3)]

    T = [Vinv[0][y][:, None] * W[0] + Vinv[1][y][:, None] * W[1]
         + Vinv[2][y][:, None] * W[2] for y in range(3)]   # 3 x (L,6PS)
    S_corr = all_reduce(T[0].T @ W[0] + T[1].T @ W[1] + T[2].T @ W[2], group)
    b_s = b_p - all_reduce(T[0].T @ b_l[0] + T[1].T @ b_l[1] + T[2].T @ b_l[2], group)

    S = Hf + torch.diag(lam * torch.diagonal(Hf) + 1e-8) - S_corr
    mvec = movable.repeat_interleave(6).to(torch.float32)
    Sf = S * mvec[:, None] * mvec[None, :] + torch.diag(1.0 - mvec)
    with span("ba.solve"):
        delta_f = spd_solve(Sf, b_s * mvec) * mvec
    delta_p = delta_f.reshape(PS, 6) * movable[:, None]

    r = [b_l[m] - W[m] @ delta_f for m in range(3)]
    dl = torch.stack([Vinv[y][0] * r[0] + Vinv[y][1] * r[1] + Vinv[y][2] * r[2]
                      for y in range(3)], -1)
    if fixed_b:
        return delta_p, torch.zeros((Pb, 6), dtype=delta_p.dtype,
                                    device=delta_p.device), dl
    return delta_p[:Pa], delta_p[Pa:], dl


def _select(act, a: SE3, b: SE3) -> SE3:
    return SE3(R=torch.where(act, a.R, b.R), t=torch.where(act, a.t, b.t))


def _lm_update(prob: BundleProblem, st: LMState, bcfg: BundleConfig, deltas, trial,
               cost0, cost1, sigma_sq, ok, ok1, group=None, points_sharded=False):
    """The accept/reject step both LM paths share: the trial (its poses and
    points, reached by ``deltas``) is taken when its cost is lower and it
    keeps at least half the valid measurements (a trial whose valid count
    collapses scores a spuriously low cost); the attempted update or the
    relative cost change below threshold latches convergence, accepted or
    not, so a stalled reject loop stops too.  The costs come in summed over
    ``group``; the measurement counts, and with ``points_sharded`` the
    point update and the movable points, are summed here, so every rank
    takes the same decision.  Returns (state, act)."""
    da, db, dl = deltas
    new_pose_a, new_pose_b, new_points = trial
    accept = (cost1 < cost0) & (all_reduce(torch.sum(ok1), group) * 2
                                >= all_reduce(torch.sum(ok), group))
    pt_group = group if points_sharded else None
    n_upd = (torch.sum(da * da) + torch.sum(db * db)
             + all_reduce(torch.sum(dl * dl), pt_group))
    n_params = (6.0 * (torch.sum(prob.movable_a) + torch.sum(prob.movable_b))
                + 3.0 * all_reduce(torch.sum(prob.movable_pt), pt_group))
    upd_rms = torch.sqrt(n_upd / torch.clamp(n_params, min=1.0))
    rel_delta = torch.abs(cost0 - cost1) / torch.clamp(cost0, min=1e-20)
    converged = ((upd_rms < bcfg.update_rms_conv)
                 | (rel_delta < bcfg.residual_delta_conv))
    act = accept & ~st.converged
    lam = torch.where(st.converged, st.lam,
                      torch.where(accept, st.lam * bcfg.lambda_down,
                                  st.lam * bcfg.lambda_up))
    return LMState(
        pose_a=_select(act, new_pose_a, st.pose_a),
        pose_b=_select(act, new_pose_b, st.pose_b),
        points=torch.where(act, new_points, st.points),
        lam=torch.clamp(lam, 1e-10, 1e8),
        cost=torch.where(act, cost1, cost0),
        sigma_sq=sigma_sq,
        converged=st.converged | converged,
        accepted=st.accepted + act.to(torch.int32),
        iterations=st.iterations + (~st.converged).to(torch.int32),
        max_update=torch.where(act, upd_rms, st.max_update),
    ), act


def _lm_step_soa_carried(prob: BundleProblem, st: LMState, chi2, ok,
                         cams: CameraModel, bcfg: BundleConfig, pr: dict,
                         fixed_b: bool = False, group=None):
    """One LM iteration with the current-estimate chi2 carried in and out,
    so each iteration pays one full residual pass (the trial)."""
    with span("ba.lm_step", next(_STEP_IDS)):
        with span("ba.robust"):
            med = mest.masked_median_hist(chi2, ok, group=group)
            sigma_sq = torch.clamp(med, min=bcfg.min_sigma_px ** 2)
            w = mest.weight(mest.HUBER, chi2, sigma_sq) * ok
            cost0 = all_reduce(
                torch.sum(mest.objective_score(mest.HUBER, chi2, sigma_sq) * ok), group)
        with span("ba.schur"):
            da, db, dl = _solve_delta_soa(prob, pr, st.pose_a, st.pose_b, st.points,
                                          cams, w, st.lam, fixed_b=fixed_b, group=group)
        with span("ba.trial"):
            new_pose_a = SE3.exp(da) @ st.pose_a
            new_pose_b = st.pose_b if fixed_b else SE3.exp(db) @ st.pose_b
            new_points = st.points + dl
            chi2_1, ok1 = _resid_chi2_soa(prob, new_pose_a, new_pose_b, new_points, cams)
            cost1 = all_reduce(
                torch.sum(mest.objective_score(mest.HUBER, chi2_1, sigma_sq) * ok1), group)
        with span("ba.update"):
            st_new, act = _lm_update(prob, st, bcfg, (da, db, dl),
                                     (new_pose_a, new_pose_b, new_points), cost0, cost1,
                                     sigma_sq, ok, ok1, group=group, points_sharded=True)
            return st_new, torch.where(act, chi2_1, chi2), torch.where(act, ok1, ok)


def _lm_step_scatter(prob: BundleProblem, st: LMState, cams: CameraModel,
                     bcfg: BundleConfig, group=None) -> LMState:
    """One LM iteration of a problem without an observation table: the
    AoS residuals and Jacobians, ``_solve_delta``, and the trial scored
    under the same sigma.  Its ``ba.resid_jac`` span comes before
    ``ba.robust``, beside ``ba.schur``."""
    with span("ba.lm_step", next(_STEP_IDS)):
        with span("ba.resid_jac"):
            e, Ja, Jb, Jl, ok = _residuals_and_jacobians(prob, st.pose_a, st.pose_b,
                                                         st.points, cams)
        with span("ba.robust"):
            w, cost0, sigma_sq = _robust(e, ok, bcfg, group)
        with span("ba.schur"):
            da, db, dl = _solve_delta(prob, e, Ja, Jb, Jl, w, st.lam, group)
        with span("ba.trial"):
            new_pose_a = SE3.exp(da) @ st.pose_a
            new_pose_b = SE3.exp(db) @ st.pose_b
            new_points = st.points + dl
            e1, _, _, _, ok1 = _residuals_and_jacobians(prob, new_pose_a, new_pose_b,
                                                        new_points, cams)
            # the trial scored under the same sigma
            cost1 = all_reduce(torch.sum(mest.objective_score(
                mest.HUBER, torch.sum(e1 * e1, -1), sigma_sq) * ok1), group)
        with span("ba.update"):
            return _lm_update(prob, st, bcfg, (da, db, dl),
                              (new_pose_a, new_pose_b, new_points),
                              cost0, cost1, sigma_sq, ok, ok1, group=group)[0]


def lm_step(prob: BundleProblem, st: LMState, cams: CameraModel,
            bcfg: BundleConfig = DEFAULT_BUNDLE, fixed_b: bool = False) -> LMState:
    """One LM iteration with accept/reject; frozen once converged.  A
    problem without an observation table takes the scatter path, which
    ignores ``fixed_b`` (its movable masks say the same), as the JAX
    package's does."""
    if prob.obs_idx is None:
        return _lm_step_scatter(prob, st, cams, bcfg)
    chi2, ok = _resid_chi2_soa(prob, st.pose_a, st.pose_b, st.points, cams)
    return _lm_step_soa_carried(prob, st, chi2, ok, cams, bcfg, _soa_prep(prob),
                                fixed_b=fixed_b)[0]


def create_lm_state(prob: BundleProblem,
                    bcfg: BundleConfig = DEFAULT_BUNDLE) -> LMState:
    dt, dev = prob.points.dtype, prob.points.device

    def full(v, dtype=dt):
        return torch.full((), v, dtype=dtype, device=dev)

    return LMState(
        pose_a=prob.pose_a, pose_b=prob.pose_b, points=prob.points,
        lam=full(bcfg.lambda_init), cost=full(float("inf")),
        sigma_sq=full(1.0), converged=full(False, torch.bool),
        accepted=full(0, torch.int32), iterations=full(0, torch.int32),
        max_update=full(float("inf")),
    )


def lm_run(prob: BundleProblem, st: LMState, cams: CameraModel, n_steps: int,
           bcfg: BundleConfig = DEFAULT_BUNDLE, fixed_b: bool = False,
           group=None) -> LMState:
    """Up to n_steps LM iterations; the host chunks calls so the map-maker
    can preempt between chunks (setForceStopFlag, src/ChainBundle.cc:1309).
    Nothing is read back to the host.

    group: the ranks over which the problem is sharded (parallel/mesh.py):
    an observation-table problem by points (``shard_bundle_problem_soa``;
    ``st.points`` then holds this rank's points), a problem without one by
    measurements (``shard_bundle_problem``)."""
    if prob.obs_idx is None:
        for _ in range(n_steps):
            st = _lm_step_scatter(prob, st, cams, bcfg, group)
        return st
    pr = _soa_prep(prob)
    chi2, ok = _resid_chi2_soa(prob, st.pose_a, st.pose_b, st.points, cams)
    for _ in range(n_steps):
        st, chi2, ok = _lm_step_soa_carried(prob, st, chi2, ok, cams, bcfg, pr,
                                            fixed_b=fixed_b, group=group)
    return st


def tukey_outlier_pass(prob: BundleProblem, st: LMState, cams: CameraModel):
    """Post-optimisation Tukey scan (ChainBundle::Compute post-run,
    src/ChainBundle.cc:1368-1410).  Returns the (K,) outlier mask."""
    e, _, _, _, ok = _residuals_and_jacobians(prob, st.pose_a, st.pose_b,
                                              st.points, cams)
    chi2 = torch.sum(e * e, -1)
    sigma_sq = torch.clamp(mest.find_sigma_squared(chi2, ok),
                           min=DEFAULT_BUNDLE.min_sigma_px ** 2)
    return ok & (mest.weight(mest.TUKEY, chi2, sigma_sq) <= 0.0)


def point_depth_covariance(prob: BundleProblem, st: LMState, cams: CameraModel):
    """Marginal inverse-depth variance per point with the poses free
    (CHOLMOD computeMarginals, src/ChainBundle.cc:1414-1448), by the Schur
    identity Sigma_pt = V^-1 + V^-1 W^T S^-1 W V^-1.  Returns (median,
    per-point (L,))."""
    e, Ja, Jb, Jl, ok = _residuals_and_jacobians(prob, st.pose_a, st.pose_b,
                                                 st.points, cams)
    w, _, _ = _robust(e, ok, DEFAULT_BUNDLE)
    L = prob.points.shape[0]
    Hf, _, V, _, Wl = _assemble_flat(prob, e, Ja, Jb, Jl, w)
    eye3 = torch.eye(3, dtype=V.dtype, device=V.device)
    Vinv = inv3(V + 1e-9 * eye3) * prob.movable_pt[:, None, None]
    T = torch.einsum("lxw,lwy->lxy", Wl, Vinv)             # (L,6P,3)
    S = Hf - torch.einsum("lxy,lzy->xz", T, Wl)
    movable = torch.cat([prob.movable_a, prob.movable_b])
    mvec = movable.repeat_interleave(6).to(torch.float32)
    Sf = S * mvec[:, None] * mvec[None, :] + torch.diag(1.0 - mvec)
    # the _ex form: a library inverse that does not synchronise on CUDA
    Sinv = torch.linalg.inv_ex(Sf).inverse * mvec[:, None] * mvec[None, :]
    Sigma = Vinv + torch.einsum("lxv,xy,lyw->lvw", T, Sinv, T)

    dev = prob.points.device
    ia = (torch.zeros(L, dtype=torch.long, device=dev) if prob.pt_src_a is None
          else prob.pt_src_a.long())
    ib = (torch.zeros(L, dtype=torch.long, device=dev) if prob.pt_src_b is None
          else prob.pt_src_b.long())
    center_w = (st.pose_b[ib] @ st.pose_a[ia]).inv().t     # (L,3)
    d = st.points - center_w
    dist = torch.clamp(torch.linalg.vector_norm(d, dim=-1), min=1e-9)
    r = d / dist[:, None]
    cov = torch.einsum("li,lij,lj->l", r, Sigma, r) / dist ** 4
    has_obs = torch.zeros(L, dtype=torch.int32, device=dev).scatter_reduce(
        0, prob.m_point.long(), ok.to(torch.int32), reduce="amax") > 0
    return mest.masked_median_hist(cov, has_obs & prob.movable_pt), cov
