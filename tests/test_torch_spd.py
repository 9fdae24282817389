"""Port parity of the dense SPD solve (core/spd.py), the reduced camera
system's solver.

The port's plain version (``spd_solve`` on CPU tensors, which is
``spd_solve_reference``) is held against the JAX ``spd_solve`` (on the CPU
``jnp.linalg.solve``) and against the JAX Pallas kernels K4 (blocked) and
K5 (simple) run in interpret mode, the oracle tests/test_linalg.py uses.
The CUDA kernels themselves run only on the card (chip_smoke.py phase 3).

Tolerances, relative to max |x|:
  * random SPD (A = G G^T / n + I, kappa ~10): 1e-4, f32 solves that
    differ only in summation order;
  * the damped Schur matrix of a small LM step (kappa up to ~1e7 in f32):
    each solution's normwise backward error below 1e-5, and each within
    10 kappa 2^-24 of the f64 solution — the forward error an f32
    factorisation may carry at that condition number.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import n, t

from mcptam_tpu.core.spd import _spd_solve_pallas, spd_solve as j_spd_solve
from mcptam_tpu_torch.ba import bundle as pbundle
from mcptam_tpu_torch.ba.problems import build
from mcptam_tpu_torch.core.spd import spd_solve, spd_solve_reference


def _random_spd(nn: int, m: int, seed: int):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((nn, nn))
    A = (G @ G.T / nn + np.eye(nn)).astype(np.float32)
    B = rng.standard_normal((nn, m)).astype(np.float32)
    return A, B


def _rel(x, ref):
    return np.abs(x - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("nn", [6, 24, 96])
def test_random_spd_matches_jax(nn, m):
    A, B = _random_spd(nn, m, seed=nn * 10 + m)
    x = n(spd_solve(t(A), t(B)))
    np.testing.assert_array_equal(x, n(spd_solve_reference(t(A), t(B))))
    assert _rel(x, np.asarray(j_spd_solve(jnp.asarray(A), jnp.asarray(B)))) < 1e-4
    for blocked in (True, False):
        xk = np.asarray(_spd_solve_pallas(jnp.asarray(A), jnp.asarray(B),
                                          interpret=True, blocked=blocked))
        assert _rel(x, xk) < 1e-4, blocked


def test_vector_rhs_keeps_its_shape():
    A, B = _random_spd(24, 1, seed=7)
    x = spd_solve(t(A), t(B[:, 0]))
    assert x.shape == (24,)
    np.testing.assert_array_equal(n(x), n(spd_solve(t(A), t(B)))[:, 0])


@pytest.fixture(scope="module")
def schur():
    """(Sf, b) of the first LM step on build(4 poses, 128 points, 2 cams,
    512 measurements): n = 24 with the extrinsics fixed."""
    prob, cams = build(n_poses=4, n_points=128, n_cams=2, sparse_k=512, device="cpu")
    prob = pbundle.attach_obs_table(prob, int(pbundle.max_obs_per_point(prob)))
    got, orig = {}, pbundle.spd_solve

    def grab(A, b):
        got["A"], got["b"] = A.clone(), b.clone()
        return orig(A, b)

    pbundle.spd_solve = grab
    try:
        pbundle.lm_step(prob, pbundle.create_lm_state(prob), cams, fixed_b=True)
    finally:
        pbundle.spd_solve = orig
    return n(got["A"]), n(got["b"])[:, None]


def _backward_error(A, x, b):
    A, x, b = (np.asarray(v, np.float64) for v in (A, x, b))
    return (np.abs(A @ x - b).max()
            / (np.abs(A).sum(1).max() * np.abs(x).max() + np.abs(b).max()))


def test_schur_matrix_matches_jax(schur):
    A, B = schur
    assert A.shape == (24, 24)
    kappa = np.linalg.cond(A.astype(np.float64))
    x64 = np.linalg.solve(A.astype(np.float64), B.astype(np.float64))
    fwd_tol = max(1e-4, 10.0 * kappa * 2.0 ** -24)
    sols = {"port": n(spd_solve(t(A), t(B))),
            "jax": np.asarray(j_spd_solve(jnp.asarray(A), jnp.asarray(B)))}
    for blocked in (True, False):
        sols[f"pallas blocked={blocked}"] = np.asarray(_spd_solve_pallas(
            jnp.asarray(A), jnp.asarray(B), interpret=True, blocked=blocked))
    for name, x in sols.items():
        assert _backward_error(A, x, B) < 1e-5, name
        assert _rel(x, x64) < fwd_tol, (name, kappa)
