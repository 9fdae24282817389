"""Port parity of the dense SPD solve (core/spd.py), the reduced camera
system's solver.

The port's plain version (``spd_solve`` on CPU tensors, which is
``spd_solve_reference``) is held against the JAX ``spd_solve`` (on the CPU
``jnp.linalg.solve``) and against the JAX Pallas kernels K4 (blocked) and
K5 (simple) run in interpret mode, the oracle tests/test_linalg.py uses.
The CUDA kernels themselves run only on the card (chip_smoke.py phase 3);
here a numpy emulation of K5's schedule in csrc/spd.cu (packed upper
triangle, 2-D cyclic ownership over 1024 threads, one step per pivot,
entries in registers up to n = 128, rows scaled after the last step) is
held to the JAX K5 in interpret mode, and checks that every step updates
each trailing entry exactly once.

Tolerances, relative to max |x|:
  * random SPD (A = G G^T / n + I, kappa ~10): 1e-4, f32 solves that
    differ only in summation order (the emulation: in 1/sqrt against the
    TPU kernel's rsqrt);
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


def _urow(r, n):
    """Offset of row r of csrc/spd.cu's packed upper triangle."""
    return r * n - r * (r - 1) // 2


def _k5_emulate(A, b):
    """spd_simple_kernel's factor and substitutions, thread by thread
    (numpy over the (warp, lane) grid), m = 1."""
    A = np.asarray(A, np.float32)
    nn = A.shape[0]
    R = (nn + 31) // 32
    reg = R <= 4
    U = np.zeros(nn * (nn + 1) // 2, np.float32)
    for r in range(nn):
        U[_urow(r, nn):_urow(r, nn) + nn - r] = A[r, r:]
    warp, lane = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    last_ok = lane + 32 * (R - 1) < nn
    kbase = [_urow(warp + 32 * c, nn) - (warp + 32 * c) + lane for c in range(R)]

    def entry(a, c):           # (row block a, column block c): i >= k, i < n
        return ((a > c) | (lane >= warp)) & ((a != R - 1) | last_ok)

    def at(ix):
        return U[np.clip(ix, 0, U.size - 1)]

    regs = {(a, c): np.where((warp + 32 * c < nn) & entry(a, c), at(kbase[c] + 32 * a), 0)
            for c in range(R) for a in range(c, R)} if reg else {}
    for j in range(nn):
        cj = _urow(j, nn) - j
        inv = np.float32(1) / np.sqrt(np.maximum(U[cj + j], np.float32(1e-12)))
        b0 = np.where(j < warp, 0, (j - warp) // 32 + 1)
        li = [np.where((a >= b0) & ((a != R - 1) | last_ok), at(cj + lane + 32 * a) * inv, 0)
              .astype(np.float32) for a in range(R)]
        new, touched = U.copy(), np.zeros(U.size, int)
        for c in range(R):
            act = (c >= b0) & (warp + 32 * c < nn)
            lk = (at(cj + warp + 32 * c) * inv).astype(np.float32)
            for a in range(c, R):
                m = act & entry(a, c)
                if reg:
                    regs[a, c] = np.where(act, (regs[a, c] - li[a] * lk).astype(np.float32),
                                          regs[a, c])
                    done = m & (c == (j + 1) // 32) & (warp == (j + 1) % 32)
                    new[kbase[c][done] + 32 * a] = regs[a, c][done]
                else:
                    ix = kbase[c][m] + 32 * a
                    np.add.at(touched, ix, 1)
                    new[ix] = (U[ix] - li[a][m] * lk[m]).astype(np.float32)
        if not reg:
            for k in range(j + 1, nn):
                assert np.all(touched[_urow(k, nn):_urow(k, nn) + nn - k] == 1), (j, k)
        U = new
    for r in range(nn):
        row = slice(_urow(r, nn), _urow(r, nn) + nn - r)
        U[row] = U[row] * (np.float32(1) / np.sqrt(np.maximum(U[_urow(r, nn)],
                                                              np.float32(1e-12))))
    x = np.asarray(b, np.float32).reshape(-1).copy()
    d = np.maximum(np.array([U[_urow(i, nn)] for i in range(nn)]), np.float32(1e-12))
    for j in range(nn):
        x[j] = x[j] / d[j]
        x[j + 1:] = x[j + 1:] - U[_urow(j, nn) + 1:_urow(j, nn) + nn - j] * x[j]
    for j in range(nn - 1, -1, -1):
        x[j] = x[j] / d[j]
        x[:j] = x[:j] - np.array([U[_urow(i, nn) - i + j] for i in range(j)], np.float32) * x[j]
    return x[:, None]


@pytest.mark.parametrize("nn", [5, 40, 96, 130])
def test_k5_schedule_matches_jax_kernel(nn):
    """K5's schedule (registers up to n = 128, shared memory above) solves
    what the JAX K5 solves, within the f32 tolerance."""
    A, B = _random_spd(nn, 1, seed=nn)
    xk = np.asarray(_spd_solve_pallas(jnp.asarray(A), jnp.asarray(B), interpret=True,
                                      blocked=False))
    assert _rel(_k5_emulate(A, B), xk) < 1e-4
