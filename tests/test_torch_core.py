"""Port parity of core/: SE3, camera model, M-estimators, small solves.

Tolerance: 1e-5 relative (+ a small absolute floor) — both sides are f32
with the same formulas; only reduction order and libm ulps differ."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, np_get, t

from mcptam_tpu.core import camera as jcam, linalg as jlin, mest as jmest, se3 as jse3
from mcptam_tpu.io.synthetic import make_rig as jmake_rig
from mcptam_tpu_torch import convert
from mcptam_tpu_torch.core import camera as pcam, linalg as plin, mest as pmest, se3 as pse3
from mcptam_tpu_torch.io.synthetic import make_rig as pmake_rig

RTOL, ATOL = 1e-5, 1e-5


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(n(a), n(b), rtol=rtol, atol=atol)


@pytest.fixture
def tangents(rng):
    v = rng.normal(size=(64, 6)).astype(np.float32) * 0.5
    v[:8, 3:] *= 1e-3          # small-angle series branch
    v[8, 3:] = [0.0, 0.0, 3.1]  # near pi
    return v


def test_se3_exp_ln(tangents):
    J = jse3.SE3.exp(jnp.asarray(tangents))
    P = pse3.SE3.exp(t(tangents))
    close(P.R, J.R)
    close(P.t, J.t)
    close(P.ln(), J.ln(), atol=1e-4)


def test_se3_compose_inv_apply(rng, tangents):
    a, b = tangents[:32], tangents[32:]
    x = rng.normal(size=(32, 3)).astype(np.float32)
    Ja, Jb = jse3.SE3.exp(jnp.asarray(a)), jse3.SE3.exp(jnp.asarray(b))
    Pa, Pb = pse3.SE3.exp(t(a)), pse3.SE3.exp(t(b))
    close((Pa @ Pb).R, (Ja @ Jb).R)
    close((Pa @ Pb).t, (Ja @ Jb).t)
    close(Pa.inv().t, Ja.inv().t)
    close(Pa.apply(t(x)), Ja.apply(jnp.asarray(x)))


def test_so3_ln_and_rotation_mean(rng, tangents):
    R = jse3.so3_exp(jnp.asarray(tangents[:, 3:]))
    close(pse3.so3_ln(t(R)), jse3.so3_ln(R), atol=1e-4)
    Rs = jse3.so3_exp(jnp.asarray(rng.normal(size=(4, 3)).astype(np.float32) * 0.05))
    mask = np.array([1, 1, 0, 1], np.float32)
    close(pse3.geodesic_rotation_mean(t(Rs), t(mask)),
          jse3.geodesic_rotation_mean(Rs, jnp.asarray(mask)))


def test_solve_spd_and_inv3(rng):
    A = rng.normal(size=(16, 6, 6)).astype(np.float32)
    H = A @ A.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)
    b = rng.normal(size=(16, 6)).astype(np.float32)
    close(plin.solve_spd(t(H), t(b)), jlin.solve_spd(jnp.asarray(H), jnp.asarray(b)))
    M = H[:, :3, :3]
    close(plin.inv3(t(M)), jlin.inv3(jnp.asarray(M)))


def test_mest(rng):
    e = (rng.normal(size=(3, 200)) ** 2).astype(np.float32)
    mask = rng.random((3, 200)) > 0.3
    med_j = jmest.masked_median_bisect(jnp.asarray(e), jnp.asarray(mask))
    close(pmest.masked_median_bisect(t(e), t(mask)), med_j)
    sig_j = jmest.find_sigma_squared(jnp.asarray(e), jnp.asarray(mask))
    close(pmest.find_sigma_squared(t(e), t(mask)), sig_j)
    for kind in (pmest.TUKEY, pmest.HUBER):
        close(pmest.weight(kind, t(e), t(sig_j)[:, None]),
              jmest.weight(kind, jnp.asarray(e), sig_j[:, None]))


def test_make_rig_matches():
    jc, jcfb = jmake_rig(3, 240, 320, spread_deg=25.0)
    pc, pcfb = pmake_rig(3, 240, 320, spread_deg=25.0, device="cpu")
    ref = np_get(jc)
    for name, val in convert.to_numpy(pc).items():
        close(val, getattr(ref, name))
    close(pcfb.R, jcfb.R)
    close(pcfb.t, jcfb.t)


def test_camera_project_unproject_derivs(rng):
    jc, _ = jmake_rig(2, 240, 320)
    pc = convert.camera_from_numpy(np_get(jc), device="cpu")
    v = rng.normal(size=(2, 500, 3)).astype(np.float32)
    v[..., 2] = np.abs(v[..., 2]) + 0.2
    uv_j, ok_j = jax.vmap(jcam.project)(jc, jnp.asarray(v))
    uv_p, ok_p = pcam.project(pc[:, None], t(v))
    close(uv_p, uv_j, atol=1e-3)   # pixels of a 320-wide image
    assert (n(ok_p) == n(ok_j)).mean() > 0.998
    uv = (rng.random((2, 500, 2)) * [319, 239]).astype(np.float32)
    close(pcam.unproject(pc[:, None], t(uv)),
          jax.vmap(jcam.unproject)(jc, jnp.asarray(uv)))
    close(pcam.projection_derivs_sphere(pc[:, None], t(v)),
          jax.vmap(jcam.projection_derivs_sphere)(jc, jnp.asarray(v)),
          rtol=1e-4, atol=1e-3)
    for a, b in zip(pcam.cam_sphere_deriv(t(v)), jcam.cam_sphere_deriv(jnp.asarray(v))):
        close(a, b)
    close(pcam.project_jacobian_point(pc[:, None], t(v)),
          jax.vmap(jcam.project_jacobian_point)(jc, jnp.asarray(v)),
          rtol=1e-4, atol=1e-3)
