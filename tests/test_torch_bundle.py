"""Port parity of bundle adjustment (ba/bundle.py, ba/problems.py and the
masked median of core/mest.py).

Both packages get one problem: scripts/bench_ba.py::build(n_poses=4,
n_points=128, n_cams=2, sparse_k=512) drawn by the JAX script, carried to
the port with convert.bundle_problem_from_numpy.  The port's own build is
held against the script on the same seed.  On the CPU the port's reduced
system takes the plain solve.  Tolerances:
  * integers and flags (observation table, ok masks, accept counts,
    iterations, converged, the Tukey mask): exact;
  * residuals and Jacobians: 1e-4 absolute on values of order 1-100
    (level-0 pixels; f32 projections through a 31-term polynomial);
  * after LM: poses 1e-4 (metres and rotation entries), points 2e-3 m,
    costs 1e-4 relative.  The damped reduced system of this problem has
    kappa ~1e7 in f32 (tests/test_torch_spd.py), so summation-order
    differences move the solution along its weak directions: the points
    of the first step, whose update reaches 0.5 m, differ by up to 9e-4;
  * the depth covariance: 1e-3 relative.
The LM accept decisions are integers that follow from cost comparisons.
Near the optimum a step changes the cost by less than f32 summation-order
noise, so the ten-step run starts from a perturbed state with
lambda_init = 1e3: every step then lowers the cost by at least 3e-5 of
it, twenty times the two packages' cost disagreement (checked in the
test), and the decisions agree exactly.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import n, np_get, t

from mcptam_tpu.ba import bundle as jb
from mcptam_tpu.core import mest as jmest
from mcptam_tpu_torch import convert
from mcptam_tpu_torch.ba import bundle as pb
from mcptam_tpu_torch.ba.problems import build as p_build
from mcptam_tpu_torch.core import mest as pmest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
from bench_ba import build as j_build  # noqa: E402

KW = dict(n_poses=4, n_points=128, n_cams=2, sparse_k=512)


@pytest.fixture(scope="module")
def problem():
    jprob, jcams = j_build(**KW)
    D = int(jb.max_obs_per_point(jprob))
    jprob = jb.attach_obs_table(jprob, D)
    pprob = convert.bundle_problem_from_numpy(np_get(jprob), device="cpu")
    pcams = convert.camera_from_numpy(np_get(jcams), device="cpu")
    return jprob, jcams, pprob, pcams


def _state_close(p, j):
    p, j = convert.to_numpy(p), np_get(j)
    for name in ("R", "t"):
        np.testing.assert_allclose(p["pose_a"][name], getattr(j.pose_a, name),
                                   rtol=0, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(p["points"], j.points, rtol=0, atol=2e-3)
    np.testing.assert_allclose(p["cost"], j.cost, rtol=1e-4)
    for name in ("accepted", "iterations", "converged"):
        np.testing.assert_array_equal(p[name], getattr(j, name), err_msg=name)


def test_build_matches_script():
    jprob, _ = j_build(**KW)
    pprob, _ = p_build(**KW, device="cpu")
    j, p = np_get(jprob), convert.to_numpy(pprob)
    for name in ("m_pose_a", "m_pose_b", "m_point", "m_cam", "m_level",
                 "m_valid", "movable_a", "movable_b", "movable_pt"):
        np.testing.assert_array_equal(p[name], getattr(j, name), err_msg=name)
    np.testing.assert_allclose(p["m_uv"], j.m_uv, rtol=0, atol=1e-3)
    np.testing.assert_allclose(p["points"], j.points, rtol=0, atol=1e-5)
    np.testing.assert_allclose(p["pose_a"]["R"], j.pose_a.R, rtol=0, atol=1e-5)
    np.testing.assert_allclose(p["pose_a"]["t"], j.pose_a.t, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shrink", [0, 2])
def test_obs_table_matches(problem, shrink):
    """D = the largest per-point count, and D two short of it (drops)."""
    jprob, _, pprob, _ = problem
    dmax = int(pb.max_obs_per_point(pprob))
    assert dmax == int(jb.max_obs_per_point(jprob)) and dmax > 2
    D = dmax - shrink
    jt = jb.attach_obs_table(jprob, D)
    pt = pb.attach_obs_table(pprob, D)
    np.testing.assert_array_equal(n(pt.obs_idx), np.asarray(jt.obs_idx))
    np.testing.assert_array_equal(n(pt.obs_valid), np.asarray(jt.obs_valid))
    assert int(pt.obs_dropped) == int(jt.obs_dropped)
    assert (int(pt.obs_dropped) > 0) == (shrink > 0)


def _perturbed(jprob, pprob, seed=1):
    """A state moved off the problem's start, the same in both packages."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(jprob.pose_a.t.shape[0], 6)).astype(np.float32) * 0.01
    d[0] = 0
    pts = np.asarray(jprob.points) + rng.normal(size=jprob.points.shape).astype(
        np.float32) * 0.02
    from mcptam_tpu.core.se3 import SE3 as JSE3
    from mcptam_tpu_torch.core.se3 import SE3
    ja = JSE3.exp(jnp.asarray(d)) @ jprob.pose_a
    pa = SE3.exp(t(d)) @ pprob.pose_a
    return (ja, jprob.pose_b, jnp.asarray(pts)), (pa, pprob.pose_b, t(pts))


def test_residuals_and_jacobians_match(problem):
    jprob, jcams, pprob, pcams = problem
    (ja, jbp, jpts), (pa, pbp, ppts) = _perturbed(jprob, pprob)
    je = jb._residuals_and_jacobians(jprob, ja, jbp, jpts, jcams)
    pe = pb._residuals_and_jacobians(pprob, pa, pbp, ppts, pcams)
    np.testing.assert_array_equal(n(pe[4]), np.asarray(je[4]))
    assert np.asarray(je[4]).sum() > 400
    for a, b in zip(pe[:4], je[:4]):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=0, atol=1e-4)
    # the SoA passes: residual-only over all measurements, and residuals +
    # Jacobians at the observation-table entries
    jc, jok = jb._resid_chi2_soa(jprob, ja, jbp, jpts, jcams)
    pc, pok = pb._resid_chi2_soa(pprob, pa, pbp, ppts, pcams)
    np.testing.assert_array_equal(n(pok), np.asarray(jok))
    np.testing.assert_allclose(n(pc), np.asarray(jc), rtol=1e-4, atol=1e-4)
    js = jb._resid_jac_soa(jprob, ja, jbp, jpts, jcams, jb._soa_prep(jprob))
    ps = pb._resid_jac_soa(pprob, pa, pbp, ppts, pcams, pb._soa_prep(pprob))
    np.testing.assert_array_equal(n(ps[4]), np.asarray(js[4]))
    for pj, jj in zip(ps[:4], js[:4]):
        np.testing.assert_allclose(
            np.stack([n(x) for x in np.ravel(np.array(pj, dtype=object))]),
            np.stack([np.asarray(x) for x in np.ravel(np.array(jj, dtype=object))]),
            rtol=0, atol=1e-4)


def test_inv3_soa_matches(problem):
    rng = np.random.default_rng(5)
    G = rng.normal(size=(64, 3, 3)).astype(np.float32)
    V = G @ np.swapaxes(G, 1, 2) + np.eye(3, dtype=np.float32)
    comps = [V[:, 0, 0], V[:, 0, 1], V[:, 0, 2], V[:, 1, 1], V[:, 1, 2], V[:, 2, 2]]
    jv = jb._inv3_soa(*map(jnp.asarray, comps))
    pv = pb._inv3_soa(*map(t, comps))
    for a, b in zip(pv, jv):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fixed_b", [True, False])
def test_lm_step_matches(problem, fixed_b):
    jprob, jcams, pprob, pcams = problem
    jst = jax.jit(lambda p, s: jb.lm_step(p, s, jcams, fixed_b=fixed_b))(
        jprob, jb.create_lm_state(jprob))
    pst = pb.lm_step(pprob, pb.create_lm_state(pprob), pcams, fixed_b=fixed_b)
    assert int(jst.accepted) == 1
    _state_close(pst, jst)
    np.testing.assert_allclose(n(pst.lam), np.asarray(jst.lam), rtol=1e-6)
    np.testing.assert_allclose(n(pst.sigma_sq), np.asarray(jst.sigma_sq), rtol=1e-5)


def test_lm_run_matches(problem):
    """Ten LM steps from a perturbed start (poses 0.05 m / 0.017 rad,
    points 0.1 m) with lambda_init = 1e3, one step a call in the JAX
    package to see every decision: all ten accepted, as in the port."""
    from mcptam_tpu.config import BundleConfig as JBC
    from mcptam_tpu.core.se3 import SE3 as JSE3
    from mcptam_tpu_torch.config import BundleConfig as PBC
    from mcptam_tpu_torch.core.se3 import SE3

    jprob, jcams, pprob, pcams = problem
    rng = np.random.default_rng(11)
    d = (rng.normal(size=(4, 6)) * np.array([0.05] * 3 + [0.1 / 6] * 3)).astype(np.float32)
    d[0] = 0
    pts = (np.asarray(jprob.points)
           + rng.normal(size=jprob.points.shape) * 0.1).astype(np.float32)
    jbc, pbc = JBC(lambda_init=1e3), PBC(lambda_init=1e3)
    jst = jb.create_lm_state(jprob, jbc).replace(
        pose_a=JSE3.exp(jnp.asarray(d)) @ jprob.pose_a, points=jnp.asarray(pts))
    pst = pb.create_lm_state(pprob, pbc)
    pst.pose_a, pst.points = SE3.exp(t(d)) @ pprob.pose_a, t(pts)
    run = jax.jit(lambda p, s: jb.lm_run(p, s, jcams, 1, jbc, fixed_b=True))
    costs = []
    for _ in range(10):
        jst = run(jprob, jst)
        costs.append(float(jst.cost))
    pst = pb.lm_run(pprob, pst, pcams, 10, pbc, fixed_b=True)
    _state_close(pst, jst)
    assert int(jst.accepted) == 10
    drop = -np.diff(costs) / np.asarray(costs[:-1])
    assert drop.min() > 20 * abs(float(pst.cost) - costs[-1]) / costs[-1], drop


def test_tukey_outlier_pass_matches(problem):
    """Planted 40-px outliers on 12 measurements, both packages flag the
    same set (their chi2 sits ~100 sigma^2 off the Tukey cut)."""
    jprob, jcams, pprob, pcams = problem
    uv = np.asarray(jprob.m_uv).copy()
    valid = np.flatnonzero(np.asarray(jprob.m_valid))
    bad = valid[::37][:12]
    uv[bad] += 40.0
    jprob2 = jprob.replace(m_uv=jnp.asarray(uv))
    pprob2 = pprob.replace(m_uv=t(uv))
    jst = jb.create_lm_state(jprob2)
    pst = pb.create_lm_state(pprob2)
    jm = np.asarray(jb.tukey_outlier_pass(jprob2, jst, jcams))
    pm = n(pb.tukey_outlier_pass(pprob2, pst, pcams))
    np.testing.assert_array_equal(pm, jm)
    assert set(bad) <= set(np.flatnonzero(pm))


def test_point_depth_covariance_matches(problem):
    jprob, jcams, pprob, pcams = problem
    jmed, jcov = jb.point_depth_covariance(jprob, jb.create_lm_state(jprob), jcams)
    pmed, pcov = pb.point_depth_covariance(pprob, pb.create_lm_state(pprob), pcams)
    np.testing.assert_allclose(n(pcov), np.asarray(jcov), rtol=1e-3,
                               atol=1e-3 * float(np.abs(np.asarray(jcov)).max()))
    np.testing.assert_allclose(float(pmed), float(jmed), rtol=1e-3)


@pytest.mark.parametrize("frac", [0.0, 0.1, 0.7, 1.0])
def test_masked_median_hist_matches(frac):
    rng = np.random.default_rng(int(frac * 10))
    x = rng.gamma(2.0, 3.0, size=(5, 300)).astype(np.float32)
    mask = rng.random((5, 300)) < frac
    mask[0] = False                      # an empty row gives 0
    jm = np.asarray(jmest.masked_median_hist(jnp.asarray(x), jnp.asarray(mask)))
    pm = n(pmest.masked_median_hist(t(x), t(mask)))
    np.testing.assert_allclose(pm, jm, rtol=1e-6, atol=0)
    assert pm[0] == 0.0


def test_convert_bundle_round_trip(problem):
    """numpy -> port -> numpy is the identity for BundleProblem (None
    fields stay None) and LMState."""
    jprob, jcams, _, _ = problem
    jsrc = np_get(jb.attach_obs_table(jprob, 4))
    for src, fn in ((jsrc, convert.bundle_problem_from_numpy),
                    (np_get(jb.create_lm_state(jprob)), convert.lm_state_from_numpy)):
        back = convert.to_numpy(fn(src, device="cpu"))
        for key, val in back.items():
            ref = getattr(src, key)
            if ref is None:
                assert val is None, key
            elif isinstance(val, dict):
                for k2, v2 in val.items():
                    np.testing.assert_array_equal(v2, getattr(ref, k2))
                    assert v2.dtype == np.asarray(getattr(ref, k2)).dtype
            else:
                np.testing.assert_array_equal(val, ref, err_msg=key)
                assert val.dtype == np.asarray(ref).dtype, key
