"""Port parity of the dense SPD solve (core/spd.py), the reduced camera
system's solver.

The port's plain version (``spd_solve`` on CPU tensors, which is
``spd_solve_reference``) is held against the JAX ``spd_solve`` (on the CPU
``jnp.linalg.solve``) and against the JAX Pallas kernels K4 (blocked) and
K5 (simple) run in interpret mode, the oracle tests/test_linalg.py uses.
The CUDA kernels themselves run only on the card (chip_smoke.py phase 3);
here numpy emulations of their schedules in csrc/spd.cu are held to the
JAX kernels in interpret mode: K5's (packed upper triangle, 2-D cyclic
ownership over 1024 threads, one step per pivot, entries in registers up
to n = 128, rows scaled after the last step), and K4's (packed lower
triangle, panels of K4_PB columns: the diagonal block factored by lane
rows, the rows below solved row by row, the trailing update in jobs of
RT rows x 32 columns with warp 0 taking the next diagonal block's, the
substitutions by 32-row blocks).  Each checks that
every step (K5) or panel (K4) updates each trailing entry exactly once;
K4's also at n = 288, the capacity size, against a float64 solve, and
over the global path's 32 warps at n = 324 and 576, beyond the shared
range, against a float64 solve and the JAX solve (1e-3, kappa 1e4).  The
wrappers' routing (shared K4, its global path, K5's range) is checked
without a card.

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
from mcptam_tpu_torch.core.spd import (
    K4_GLOBAL_THREADS, K4_PB, MAX_SHARED_BYTES, route, shared_bytes, shared_bytes_global,
    spd_solve, spd_solve_reference,
)


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
    return _solve_rhs(lambda i, j: U[_urow(j, nn) - j + i], b)


@pytest.mark.parametrize("nn", [5, 40, 96, 130])
def test_k5_schedule_matches_jax_kernel(nn):
    """K5's schedule (registers up to n = 128, shared memory above) solves
    what the JAX K5 solves, within the f32 tolerance."""
    A, B = _random_spd(nn, 1, seed=nn)
    xk = np.asarray(_spd_solve_pallas(jnp.asarray(A), jnp.asarray(B), interpret=True,
                                      blocked=False))
    assert _rel(_k5_emulate(A, B), xk) < 1e-4


def _fma(a, b, c):
    """f32 fused multiply-add (a b + c rounded once, as fmaf)."""
    return (np.float64(a) * b + c).astype(np.float32) if np.isscalar(a) else \
        (np.asarray(a, np.float64) * b + c).astype(np.float32)


def _tri(i, k):
    """Offset of L[i][k] in csrc/spd.cu's packed lower triangle."""
    return i * (i + 1) // 2 + k


K4_RT, K4_WARPS = 16, 16   # csrc/spd.cu: RT, THREADS / 32


def _k4_ld(nn):
    return (max(nn - K4_PB, 0) + 3) // 4 * 4 + 32


def _k4_jobs(nt, warps=K4_WARPS):
    """The trailing-update jobs (column block bk, first row ir0) that each
    of the kernel's warps takes, decoded as the kernel decodes them:
    warp 0 the next diagonal block's (the first PB / RT), the other warps
    the rest in turn."""
    nq, nbk = -(-nt // K4_RT), -(-nt // 32)
    j0 = min(K4_PB // K4_RT, nq)
    jobs = []
    for warp in range(warps):
        bk = first = 0
        job, step = (0, 1) if warp == 0 else (j0 + warp - 1, warps - 1)
        while not (warp == 0 and job == j0):
            while bk < nbk and job >= first + nq - 32 * bk // K4_RT:
                first += nq - 32 * bk // K4_RT
                bk += 1
            if bk >= nbk:
                break
            jobs.append((bk, K4_RT * (32 * bk // K4_RT + job - first)))
            job += step
    return jobs


def _k4_emulate(A, b, warps=K4_WARPS):
    """spd_blocked_kernel's factor and substitutions, thread by thread
    (numpy over lanes, rows and jobs), m = 1, in f32 with fmaf where the
    kernel has it.  ``warps``: the kernel's warps (K4_WARPS for the shared
    path, K4_GLOBAL_THREADS / 32 for spd_blocked_global_kernel, which runs
    the same schedule on a factor in global memory)."""
    f32 = np.float32
    A = np.asarray(A, f32)
    nn, PB = A.shape[0], K4_PB
    ld = _k4_ld(nn)
    L = np.zeros(nn * (nn + 1) // 2, f32)
    for i in range(nn):
        L[_tri(i, 0):_tri(i, 0) + i + 1] = A[:i + 1, i]
    Pt = np.zeros((PB, ld), f32)
    lanes = np.arange(32)
    for p0 in range(0, nn, PB):
        w = min(PB, nn - p0)
        pe = p0 + w
        # 1. the diagonal block: lane r holds row p0 + r
        # (entries left of the diagonal unscaled until their step, the
        # diagonal apart in dg)
        a = np.zeros((32, PB), f32)
        dg = np.ones(32, f32)
        for r in range(w):
            a[r, :r] = L[_tri(p0 + r, p0):_tri(p0 + r, p0) + r]
            dg[r] = L[_tri(p0 + r, p0 + r)]
        lrr = np.zeros(32, f32)
        dinv = np.zeros(PB, f32)
        for j in range(w):
            d = dg[j]
            raw = a[:, j].copy()                     # a_kj, unscaled, by lane k
            inv = f32(1) / np.sqrt(np.maximum(d, f32(1e-12)))
            li = a[:, j] * inv
            lrr[j] = d * inv
            below = lanes > j
            a[below, j] = li[below]
            dg[below] = _fma(-li[below], li[below], dg[below])
            for k in range(j + 1, PB):
                m = lanes > k
                a[m, k] = _fma(-li[m], raw[k] * inv, a[m, k])
            dinv[j] = inv
        for r in range(w):
            L[_tri(p0 + r, p0):_tri(p0 + r, p0) + r] = a[r, :r]
            L[_tri(p0 + r, p0 + r)] = lrr[r]
        Dt = np.where(np.arange(PB)[:, None] < np.arange(PB)[None, :], a[:PB].T, 0)
        if pe >= nn:
            break
        # 2. the rows below, a row a thread
        rows = np.arange(pe, nn)
        ix = (rows * (rows + 1) // 2 + p0)[:, None] + np.arange(PB)
        P = L[ix]
        for j in range(PB):
            P[:, j] = P[:, j] * dinv[j]
            for k in range(j + 1, PB):
                P[:, k] = _fma(-P[:, j], Dt[j, k], P[:, k])
        L[ix] = P
        Pt[:, :nn - pe] = P.T
        # 3. the trailing update, job by job in the kernel's order
        nt = nn - pe
        touched = np.zeros(L.size, int)
        for bk, ir0 in _k4_jobs(nt, warps):
            kr = 32 * bk + lanes                                  # (32,)
            ir = ir0 + np.arange(K4_RT)                           # (RT,)
            acc = np.zeros((K4_RT, 32), f32)
            for c in range(PB):
                acc = _fma(Pt[c, ir][:, None], Pt[c, kr][None, :], acc)
            ii, kk = np.meshgrid(ir, kr, indexing="ij")
            ok = (ii < nt) & (kk <= ii)
            idx = _tri(pe + ii[ok], pe + kk[ok])
            np.add.at(touched, idx, 1)
            L[idx] = L[idx] - acc[ok]
        trail = np.concatenate([np.arange(_tri(i, pe), _tri(i, i) + 1) for i in range(pe, nn)])
        assert np.all(touched[trail] == 1) and touched.sum() == trail.size, p0
    return _solve_rhs(lambda i, j: L[_tri(i, j)], b)


def _solve_rhs(lo, b):
    """solve_rhs in csrc/spd.cu: L y = b, then L^T x = y, with L_ij =
    lo(i, j), by 32-row blocks: inside a block the warp's chain, every row
    divided by its pivot and its entries multiplied by the reciprocal; the
    block's solution then reaches the other rows as one 32-term dot
    product each, summed in order."""
    f32 = np.float32
    x = np.asarray(b, f32).reshape(-1).copy()
    nn = x.size
    rd = f32(1) / np.maximum(np.array([lo(i, i) for i in range(nn)], f32), f32(1e-12))
    blocks = [np.arange(j0, min(j0 + 32, nn)) for j0 in range(0, nn, 32)]

    def dots(rows, cols, entry):
        s = np.zeros(rows.size, f32)
        for j in cols:
            s = _fma(entry(rows, j), x[j], s)
        return s

    for blk in blocks:
        z = x[blk] * rd[blk]
        for t, j in enumerate(blk):
            later = blk[t + 1:]
            z[t + 1:] = _fma(-(lo(later, j) * rd[later]), z[t], z[t + 1:])
        x[blk] = z
        rows = np.arange(blk[-1] + 1, nn)
        x[rows] = x[rows] - dots(rows, blk, lo)
    for blk in blocks[::-1]:
        z = x[blk] * rd[blk]
        for t in range(blk.size - 1, -1, -1):
            j, earlier = blk[t], blk[:t]
            z[:t] = _fma(-(lo(j, earlier) * rd[earlier]), z[t], z[:t])
        x[blk] = z
        rows = np.arange(blk[0])
        x[rows] = x[rows] - dots(rows, blk, lambda r, j: lo(j, r))
    return x[:, None]


@pytest.mark.parametrize("nn", [5, 40, 96, 130])
def test_k4_schedule_matches_jax_kernel(nn):
    """K4's schedule (panels without per-pivot barriers) solves what the
    JAX K4 solves, within the f32 tolerance."""
    A, B = _random_spd(nn, 1, seed=nn + 1)
    xk = np.asarray(_spd_solve_pallas(jnp.asarray(A), jnp.asarray(B), interpret=True,
                                      blocked=True))
    assert _rel(_k4_emulate(A, B), xk) < 1e-4


def test_k4_schedule_at_capacity():
    """n = 288 (48 MKFs x 6), kappa 1e4 as chip_smoke.check_spd builds it:
    within SPD_TOL (1e-3) of a float64 solve; every panel updates each
    trailing entry exactly once (asserted inside the emulation)."""
    nn = 288
    rng = np.random.default_rng(288)
    Q, _ = np.linalg.qr(rng.standard_normal((nn, nn)))
    A = ((Q * np.logspace(0, 4, nn)) @ Q.T).astype(np.float32)
    A = 0.5 * (A + A.T)
    B = rng.standard_normal((nn, 1)).astype(np.float32)
    x64 = np.linalg.solve(A.astype(np.float64), B.astype(np.float64))
    assert _rel(_k4_emulate(A, B), x64) < 1e-3


@pytest.mark.parametrize("blocked,edge", [(True, 322), (False, 339)])
def test_shared_memory_range_edge(blocked, edge):
    """The wrappers' range: the largest m = 1 system whose layout fits the
    227 KB a block may use.  K4's layout is the emulation's: Pt, Dt, the
    pivot scales, the packed factor and the rhs."""
    assert shared_bytes(edge, 1, blocked) <= MAX_SHARED_BYTES < shared_bytes(edge + 1, 1, blocked)
    if blocked:
        nn = edge
        assert shared_bytes(nn, 1) == 4 * (K4_PB * _k4_ld(nn) + K4_PB * K4_PB + K4_PB
                                           + nn * (nn + 1) // 2 + nn)
    assert shared_bytes(edge, 3, blocked) == shared_bytes(edge, 1, blocked) + 4 * 2 * edge


def _spd_kappa(nn: int, seed: int):
    """Random SPD (nn, nn) with condition number 1e4, as
    chip_smoke.random_spd builds it, and a (nn, 1) rhs."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((nn, nn)))
    A = ((Q * np.logspace(0, 4, nn)) @ Q.T).astype(np.float32)
    return 0.5 * (A + A.T), rng.standard_normal((nn, 1)).astype(np.float32)


@pytest.mark.parametrize("nn", [324, 576])
def test_k4_global_schedule_matches_jax(nn):
    """K4's global path (spd_blocked_global_kernel: K4's panels over
    K4_GLOBAL_THREADS / 32 warps, the factor in global memory) beyond the
    shared range: within SPD_TOL (1e-3) of a float64 solve and of the JAX
    spd_solve; every panel updates each trailing entry exactly once."""
    assert route(nn, 1) == "spd_solve_blocked_global"
    A, B = _spd_kappa(nn, nn)
    x = _k4_emulate(A, B, warps=K4_GLOBAL_THREADS // 32)
    x64 = np.linalg.solve(A.astype(np.float64), B.astype(np.float64))
    assert _rel(x, x64) < 1e-3
    assert _rel(x, np.asarray(j_spd_solve(jnp.asarray(A), jnp.asarray(B)))) < 1e-3


@pytest.mark.parametrize("nn,m,blocked,want", [
    (96, 1, True, "spd_solve_blocked"), (322, 1, True, "spd_solve_blocked"),
    (323, 1, True, "spd_solve_blocked_global"), (384, 1, True, "spd_solve_blocked_global"),
    (1536, 1, True, "spd_solve_blocked_global"), (96, 1, False, "spd_solve_simple"),
    (339, 1, False, "spd_solve_simple"), (340, 1, False, None), (3385, 1, True, None),
])
def test_spd_route(nn, m, blocked, want):
    """The wrapper's routing: K4 in shared memory up to n = 322, its
    global path beyond, up to where its panel and rhs fill shared memory;
    K5 raises beyond n = 339 with a message that names the blocked
    default."""
    if want is None:
        with pytest.raises(ValueError, match="blocked default" if not blocked else "global"):
            route(nn, m, blocked)
    else:
        assert route(nn, m, blocked) == want
    if want == "spd_solve_blocked_global":
        assert shared_bytes(nn, m) > MAX_SHARED_BYTES >= shared_bytes_global(nn, m)
