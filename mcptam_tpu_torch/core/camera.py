"""Taylor (Scaramuzza) omnidirectional camera model (port of
mcptam_tpu/core/camera.py, ref src/TaylorCamera.cc).

Construction (``make_camera``) stays host numpy, like the reference's
RefreshParams: the inverse polynomial is fitted once per camera.  The
device functions broadcast the camera's batch dims against the point batch
dims the way numpy broadcasting does, so a rig of C cameras projecting
(C,N,3) points passes ``cams[:, None]``.

Pixel convention: ``uv[0] = x = column``, ``uv[1] = y = row``.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from mcptam_tpu_torch.config import MAX_INV_DEGREE

_INV_LEN = MAX_INV_DEGREE + 1


def polyval(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Horner evaluation; ``coeffs[..., i]`` multiplies ``x**i``."""
    n = coeffs.shape[-1]
    val = torch.zeros_like(x)
    for i in range(n - 1, 0, -1):
        val = (val + coeffs[..., i]) * x
    return val + coeffs[..., 0]


@dataclass
class CameraModel:
    """Device-side camera(s); all fields may carry leading batch dims."""

    poly: torch.Tensor             # (...,5) [a0, 0, a2, a3, a4]
    poly_deriv_mod: torch.Tensor   # (...,5)
    inv_poly: torch.Tensor         # (...,_INV_LEN)
    theta_mean: torch.Tensor       # (...)
    theta_std: torch.Tensor        # (...)
    center: torch.Tensor           # (...,2)
    affine: torch.Tensor           # (...,2,2)
    affine_inv: torch.Tensor       # (...,2,2)
    image_size: torch.Tensor       # (...,2) (width, height)
    min_theta: torch.Tensor        # (...)
    max_rho: torch.Tensor          # (...)
    one_pixel_angle: torch.Tensor  # (...)

    def __getitem__(self, idx) -> "CameraModel":
        """Index the batch dims of every field (``cams[c]``, ``cams[idx]``,
        ``cams[:, None]``)."""
        return CameraModel(**{f.name: getattr(self, f.name)[idx]
                              for f in fields(self)})


def make_camera(params9, image_size, device="cuda") -> CameraModel:
    """Build a CameraModel from the 9-vector and the (width, height) the
    camera was calibrated at and delivers (src/TaylorCamera.cc:114-190;
    the reference's binned and cropped modes wait for the calibration
    tools), with the inverse-polynomial fit (:489-604) in host numpy."""
    params9 = np.asarray(params9, dtype=np.float64)
    image_size = np.asarray(image_size, dtype=np.float64)

    a0, a2, a3, a4, xc, yc, c, d, e = params9
    poly = np.array([a0, 0.0, a2, a3, a4])
    poly_deriv_mod = np.array([-a0, 0.0, a2, 2.0 * a3, 3.0 * a4])

    center = np.array([xc, yc])
    corner = np.maximum(center, image_size - center - 1.0)
    max_rho = float(np.sqrt(np.sum(corner ** 2)))
    min_theta = float(np.arctan(np.polyval(poly[::-1], max_rho) / max_rho))

    # inverse fit: rho as a polynomial of normalized theta over the
    # strictly monotonic region, degree raised until max error < 1e-4 px
    rho_s = np.linspace(1e-6, max_rho, 4000)
    theta_s = np.arctan2(np.polyval(poly[::-1], rho_s), rho_s)
    dtheta = np.diff(theta_s)
    if np.any(dtheta >= 0):
        cut = int(np.argmax(dtheta >= 0)) + 1
        rho_s, theta_s = rho_s[:cut], theta_s[:cut]
    theta_mean = float(np.mean(theta_s))
    theta_std = float(np.std(theta_s))
    tn = (theta_s - theta_mean) / theta_std

    inv_coeffs = None
    for degree in range(2, MAX_INV_DEGREE + 1):
        V = np.vander(tn, degree + 1, increasing=True)
        sol, *_ = np.linalg.lstsq(V, rho_s, rcond=None)
        if np.max(np.abs(V @ sol - rho_s)) < 1e-4:
            inv_coeffs = sol
            break
    if inv_coeffs is None:
        inv_coeffs = sol
    inv_padded = np.zeros(_INV_LEN)
    inv_padded[: inv_coeffs.size] = inv_coeffs

    affine = np.array([[c, d], [e, 1.0]])
    affine_inv = np.linalg.inv(affine)

    def _unproject_np(uv):
        uvd = affine_inv @ (np.asarray(uv, np.float64) - center)
        z = np.polyval(poly[::-1], np.linalg.norm(uvd))
        v = np.array([uvd[0], uvd[1], z])
        return v / np.linalg.norm(v)

    v_c = _unproject_np(image_size / 2.0)
    v_d = _unproject_np(image_size / 2.0 + 1.0)
    opa = float(np.arccos(np.clip(np.dot(v_c, v_d), -1.0, 1.0)) / np.sqrt(2.0))

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)

    return CameraModel(
        poly=t(poly), poly_deriv_mod=t(poly_deriv_mod), inv_poly=t(inv_padded),
        theta_mean=t(theta_mean), theta_std=t(theta_std), center=t(center),
        affine=t(affine), affine_inv=t(affine_inv), image_size=t(image_size),
        min_theta=t(min_theta), max_rho=t(max_rho), one_pixel_angle=t(opa),
    )


def stack_cameras(cams) -> CameraModel:
    """Stack single cameras into one struct with a leading camera axis."""
    return CameraModel(**{
        f.name: torch.stack([getattr(c, f.name) for c in cams])
        for f in fields(CameraModel)
    })


def _sphere(v3: torch.Tensor, cam: CameraModel):
    x, y, z = v3[..., 0], v3[..., 1], v3[..., 2]
    norm = torch.sqrt(x * x + y * y)
    theta = torch.atan2(z, norm)
    rho = polyval(cam.inv_poly, (theta - cam.theta_mean) / cam.theta_std)
    zero_n = norm == 0
    norm_safe = torch.where(zero_n, torch.ones_like(norm), norm)
    zero = torch.zeros_like(norm)
    cos_phi = torch.where(zero_n, zero, x / norm_safe)
    sin_phi = torch.where(zero_n, zero, y / norm_safe)
    return theta, rho, zero_n, cos_phi, sin_phi


def project(cam: CameraModel, v3: torch.Tensor):
    """Camera-frame point(s) -> (uv, valid); invalid outside the model's
    field of view or the image (src/TaylorCamera.cc:202-287)."""
    theta, rho, zero_n, cos_phi, sin_phi = _sphere(v3, cam)
    valid = theta >= cam.min_theta
    rho = torch.where(zero_n, torch.zeros_like(rho), rho)
    uv_dist = torch.stack([cos_phi * rho, sin_phi * rho], -1)
    uv = torch.einsum("...ij,...j->...i", cam.affine, uv_dist) + cam.center
    inside = (
        (uv[..., 0] >= 0) & (uv[..., 1] >= 0)
        & (uv[..., 0] < cam.image_size[..., 0] - 1)
        & (uv[..., 1] < cam.image_size[..., 1] - 1)
    )
    return uv, valid & inside


def unproject(cam: CameraModel, uv: torch.Tensor) -> torch.Tensor:
    """Pixel coords -> unit-sphere direction (src/TaylorCamera.cc:319-346)."""
    uv_dist = torch.einsum("...ij,...j->...i", cam.affine_inv, uv - cam.center)
    rho = torch.linalg.vector_norm(uv_dist, dim=-1)
    z = polyval(cam.poly, rho)
    v3 = torch.cat([uv_dist, z[..., None]], -1)
    n = torch.linalg.vector_norm(v3, dim=-1, keepdim=True)
    return v3 / torch.where(n == 0, torch.ones_like(n), n)


def projection_derivs_sphere(cam: CameraModel, v3: torch.Tensor) -> torch.Tensor:
    """2x2 d(uv)/d(theta,phi) at v3 (src/TaylorCamera.cc:353-383)."""
    _, rho, _, cos_phi, sin_phi = _sphere(v3, cam)
    w = polyval(cam.poly, rho)
    denom = polyval(cam.poly_deriv_mod, rho)
    drho_dtheta = (rho * rho + w * w) / torch.where(
        denom == 0, torch.ones_like(denom), denom)
    d_theta = torch.stack([cos_phi * drho_dtheta, sin_phi * drho_dtheta], -1)
    d_phi = torch.stack([-sin_phi * rho, cos_phi * rho], -1)
    cols = torch.stack([d_theta, d_phi], -1)
    return torch.einsum("...ij,...jk->...ik", cam.affine, cols)


def cam_sphere_deriv(v3: torch.Tensor):
    """d(theta)/d(point), d(phi)/d(point), each (...,3)
    (src/TaylorCamera.cc:617-669)."""
    x, y, z = v3[..., 0], v3[..., 1], v3[..., 2]
    x2, y2, z2 = x * x, y * y, z * z
    n2 = x2 + y2
    n = torch.sqrt(n2)
    dn = n2 * n + n * z2
    one = torch.ones_like(n)
    zero = torch.zeros_like(n)
    dn_safe = torch.where(dn == 0, one, dn)
    zero_n = n == 0
    r2 = n2 + z2
    d_theta = torch.stack([
        torch.where(zero_n, zero, -z * x / dn_safe),
        torch.where(zero_n, zero, -z * y / dn_safe),
        torch.where(zero_n, zero, n / torch.where(r2 == 0, one, r2)),
    ], -1)
    n2_safe = torch.where(n2 == 0, one, n2)
    d_phi = torch.stack([
        torch.where(zero_n, zero, -y / n2_safe),
        torch.where(zero_n, zero, x / n2_safe),
        zero,
    ], -1)
    return d_theta, d_phi


def project_jacobian_point(cam: CameraModel, v3: torch.Tensor) -> torch.Tensor:
    """Full (...,2,3) d(uv)/d(v3_cam): the two derivatives above chained."""
    duv = projection_derivs_sphere(cam, v3)
    d_theta, d_phi = cam_sphere_deriv(v3)
    return torch.einsum("...ij,...jk->...ik", duv, torch.stack([d_theta, d_phi], -2))


# ---------------------------------------------------------------------------
# Scalar-component variants for the bundle-adjustment hot path: every
# per-measurement quantity a flat (N,) tensor, lists standing in for the
# small fixed dims (the reference's layout, kept so the two packages
# compute the same expressions in the same order).
# ---------------------------------------------------------------------------

def camera_soa(cam: CameraModel, idx: torch.Tensor) -> dict:
    """Per-measurement camera parameters as flat component tensors; cam
    carries a leading camera axis, idx is the (N,) camera index."""
    idx = idx.long()

    def g(t):
        return t[idx]

    return {
        "inv_poly": [g(cam.inv_poly[..., i]) for i in range(cam.inv_poly.shape[-1])],
        "poly": [g(cam.poly[..., i]) for i in range(cam.poly.shape[-1])],
        "pdm": [g(cam.poly_deriv_mod[..., i])
                for i in range(cam.poly_deriv_mod.shape[-1])],
        "theta_mean": g(cam.theta_mean),
        "theta_std": g(cam.theta_std),
        "min_theta": g(cam.min_theta),
        "cx": g(cam.center[..., 0]),
        "cy": g(cam.center[..., 1]),
        "a00": g(cam.affine[..., 0, 0]),
        "a01": g(cam.affine[..., 0, 1]),
        "a10": g(cam.affine[..., 1, 0]),
        "a11": g(cam.affine[..., 1, 1]),
        "wm1": g(cam.image_size[..., 0]) - 1.0,
        "hm1": g(cam.image_size[..., 1]) - 1.0,
    }


def _horner_soa(coeffs: list, x: torch.Tensor) -> torch.Tensor:
    val = torch.zeros_like(x)
    for i in range(len(coeffs) - 1, 0, -1):
        val = (val + coeffs[i]) * x
    return val + coeffs[0]


def project_chain_soa(camf: dict, x, y, z, with_derivs: bool = True):
    """Projection and, with_derivs, the derivative chain d uv / d p_cam as
    a 2x3 nested list (ref EdgeChainMeas::linearizeOplus,
    src/ChainBundle.cc:449-749).  Returns a dict with u, v, ok[, duv]."""
    n2 = x * x + y * y
    norm = torch.sqrt(n2)
    theta = torch.atan2(z, norm)
    fov_ok = theta >= camf["min_theta"]
    rho = _horner_soa(camf["inv_poly"], (theta - camf["theta_mean"]) / camf["theta_std"])

    zero_n = norm == 0
    one = torch.ones_like(norm)
    zero = torch.zeros_like(norm)
    norm_safe = torch.where(zero_n, one, norm)
    cos_phi = torch.where(zero_n, zero, x / norm_safe)
    sin_phi = torch.where(zero_n, zero, y / norm_safe)
    rho = torch.where(zero_n, zero, rho)

    ux = cos_phi * rho
    uy = sin_phi * rho
    u = camf["a00"] * ux + camf["a01"] * uy + camf["cx"]
    v = camf["a10"] * ux + camf["a11"] * uy + camf["cy"]
    ok = fov_ok & (u >= 0) & (v >= 0) & (u < camf["wm1"]) & (v < camf["hm1"])
    out = {"u": u, "v": v, "ok": ok}
    if not with_derivs:
        return out

    w_ = _horner_soa(camf["poly"], rho)
    denom = _horner_soa(camf["pdm"], rho)
    drho = (rho * rho + w_ * w_) / torch.where(denom == 0, one, denom)
    # duv2 = affine @ [[c*drho, -s*rho], [s*drho, c*rho]]
    d00 = camf["a00"] * cos_phi * drho + camf["a01"] * sin_phi * drho
    d01 = -camf["a00"] * sin_phi * rho + camf["a01"] * cos_phi * rho
    d10 = camf["a10"] * cos_phi * drho + camf["a11"] * sin_phi * drho
    d11 = -camf["a10"] * sin_phi * rho + camf["a11"] * cos_phi * rho

    # sphere coordinate derivatives (GetCamSphereDeriv)
    z2 = z * z
    n3dn = norm * n2 + norm * z2
    dn_safe = torch.where(n3dn == 0, one, n3dn)
    r2 = n2 + z2
    dth = [
        torch.where(zero_n, zero, -z * x / dn_safe),
        torch.where(zero_n, zero, -z * y / dn_safe),
        torch.where(zero_n, zero, norm / torch.where(r2 == 0, one, r2)),
    ]
    n2_safe = torch.where(zero_n, one, n2)
    dph = [
        torch.where(zero_n, zero, -y / n2_safe),
        torch.where(zero_n, zero, x / n2_safe),
        zero,
    ]
    out["duv"] = [
        [d00 * dth[l] + d01 * dph[l] for l in range(3)],
        [d10 * dth[l] + d11 * dph[l] for l in range(3)],
    ]
    return out
