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
K4's also at n = 288, the capacity size, against a float64 solve.  K4's
global path beyond the shared range is a sequence of launches, emulated
launch by launch: the load, per panel of NB columns the redundant
diagonal factor, the rows below solved, the forward step and the
trailing update in TILE x TILE tiles with the right-hand side's rows,
then the back-substitution by 32-row blocks; held at n = 324, 331, 384
and 576 (and m = 3) to a float64 solve and the JAX solve (1e-3, kappa
1e4), its tiles checked to cover every trailing lower entry once.  The
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
    K4_GLOBAL_NB, K4_GLOBAL_TILE, K4_PB, MAX_SHARED_BYTES, global_launches, global_ld,
    global_work_floats, route, shared_bytes, shared_bytes_global, spd_solve,
    spd_solve_reference,
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


def _k4_emulate(A, b):
    """spd_blocked_kernel's factor and substitutions, thread by thread
    (numpy over lanes, rows and jobs), m = 1, in f32 with fmaf where the
    kernel has it."""
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
        for bk, ir0 in _k4_jobs(nt):
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
    x = np.asarray(b, np.float32).reshape(-1).copy()
    return _back_rhs(lo, _forward_rhs(lo, x))[:, None]


def _rhs_blocks(nn):
    return [np.arange(j0, min(j0 + 32, nn)) for j0 in range(0, nn, 32)]


def _dots(x, rows, cols, entry):
    """Each row's dot product with x[cols], summed in order from zero."""
    s = np.zeros(rows.size, np.float32)
    for j in cols:
        s = _fma(entry(rows, j), x[j], s)
    return s


def _recip_pivots(lo, nn):
    return np.float32(1) / np.maximum(np.array([lo(i, i) for i in range(nn)], np.float32),
                                      np.float32(1e-12))


def _forward_rhs(lo, x):
    """solve_rhs's forward half on one right-hand side x (n,), in place."""
    nn = x.size
    rd = _recip_pivots(lo, nn)
    for blk in _rhs_blocks(nn):
        z = x[blk] * rd[blk]
        for t, j in enumerate(blk):
            later = blk[t + 1:]
            z[t + 1:] = _fma(-(lo(later, j) * rd[later]), z[t], z[t + 1:])
        x[blk] = z
        rows = np.arange(blk[-1] + 1, nn)
        x[rows] = x[rows] - _dots(x, rows, blk, lo)
    return x


def _back_rhs(lo, x):
    """solve_rhs's back half (and global_back's) on one right-hand side x
    (n,), in place: L^T x = x by 32-row blocks from the bottom."""
    nn = x.size
    rd = _recip_pivots(lo, nn)
    for blk in _rhs_blocks(nn)[::-1]:
        z = x[blk] * rd[blk]
        for t in range(blk.size - 1, -1, -1):
            j, earlier = blk[t], blk[:t]
            z[:t] = _fma(-(lo(j, earlier) * rd[earlier]), z[t], z[:t])
        x[blk] = z
        rows = np.arange(blk[0])
        x[rows] = x[rows] - _dots(x, rows, blk, lambda r, j: lo(j, r))
    return x


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


def _source_constant(name):
    """An ``constexpr int`` of csrc/spd.cu."""
    import re
    from pathlib import Path

    import mcptam_tpu_torch.csrc as csrc

    text = (Path(csrc.__file__).parent / "spd.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_k4_global_constants_match_the_source():
    """The wrapper's and the emulation's NB and TILE are the kernel's."""
    assert (K4_GLOBAL_NB, K4_GLOBAL_TILE) == (_source_constant("NB"), _source_constant("TILE"))


def _tri_row(b):
    """csrc/spd.cu ``tri_row``: the row r of a lower triangle of blocks,
    numbered row by row, that holds block b (the kernel's float square
    root and its corrections)."""
    r = int((np.sqrt(np.float32(8 * b + 1), dtype=np.float32) - 1) * np.float32(0.5))
    while r * (r + 1) // 2 > b:
        r -= 1
    while (r + 1) * (r + 2) // 2 <= b:
        r += 1
    return r


def _global_tiles(nn, pe):
    """The trailing update's tiles (ti, tk) after a panel ending at pe, as
    global_update's blocks decode their index."""
    nt = -(-(nn - pe) // K4_GLOBAL_TILE)
    out = []
    for b in range(nt * (nt + 1) // 2):
        ti = _tri_row(b)
        out.append((ti, b - ti * (ti + 1) // 2))
    return out


def _tile_mask(nn, pe, ti, tk):
    """Rows, columns and the entries a tile writes: i, k < n, and i >= k in
    a diagonal tile."""
    T = K4_GLOBAL_TILE
    i = pe + T * ti + np.arange(T)
    k = pe + T * tk + np.arange(T)
    ii, kk = np.meshgrid(i, k, indexing="ij")
    return ii, kk, (ii < nn) & (kk < nn) & ((ti != tk) | (kk <= ii))


def _global_diagonal(D, w):
    """global_diagonal on the staged block D (NB x NB, lower, zero
    elsewhere): returns Dt (Dt[j][k] = L_kj, L_jj on the diagonal, zero
    below), dinv and rdiag.  Rows past w are zero with pivot 1."""
    f32, NB = np.float32, K4_GLOBAL_NB
    r = np.arange(NB)
    a = np.where((r[:, None] < w) & (np.arange(NB)[None, :] < r[:, None]), D, 0).astype(f32)
    dg = np.where(r < w, np.diag(D), 1).astype(f32)
    Dt, lrr, dinv = np.zeros((NB, NB), f32), np.ones(NB, f32), np.zeros(NB, f32)
    for j in range(NB):
        d = dg[j]
        inv = f32(1) / np.sqrt(np.maximum(d, f32(1e-12)))
        li = a[:, j] * inv
        lrr[j] = d * inv
        below = r > j
        dg[below] = _fma(-li[below], li[below], dg[below])
        Dt[j, below] = li[below]
        for k in range(j + 1, NB):              # the entries that are read: r > k
            rows = r > k
            a[rows, k] = _fma(-li[rows], Dt[j, k], a[rows, k])
        dinv[j] = inv
    Dt[r, r] = lrr
    rdiag = f32(1) / np.maximum(lrr, f32(1e-12))
    return Dt, dinv, rdiag


def _global_emulate(A, B):
    """mcptam_spd_solve_global's launch sequence, launch by launch, in f32
    with fmaf where the kernels have it."""
    f32, NB, T = np.float32, K4_GLOBAL_NB, K4_GLOBAL_TILE
    A = np.asarray(A, f32)
    nn, m = A.shape[0], B.shape[1]
    ld = global_ld(nn)
    W = np.zeros((nn, ld), f32)                 # global_load: W[i][k] = A[k][i], k <= i
    il = np.tril_indices(nn)
    W[il] = A.T[il]
    Y = np.asarray(B, f32).copy()
    Dg = np.zeros((NB, NB), f32)
    launches = 1
    for p0 in range(0, nn, NB):
        w = min(NB, nn - p0)
        pe = p0 + w
        # global_panel
        launches += 1
        D = np.zeros((NB, NB), f32)
        D[:w, :w] = np.tril(W[p0:pe, p0:pe])
        Dt, dinv, rdiag = _global_diagonal(D, w)
        L_pp = Dt.T[:w, :w]                     # the factored block, lower
        if pe == nn:
            W[p0:pe, p0:pe] = np.where(np.tri(w, dtype=bool), L_pp, W[p0:pe, p0:pe])
        else:
            Dg[...] = Dt
        for c in range(m):                      # the forward step, a warp a column
            y = np.zeros(NB, f32)
            y[:w] = Y[p0:pe, c]
            for j in range(w):
                xj = y[j] * rdiag[j]
                y[j] = xj
                y[j + 1:] = _fma(-Dt[j, j + 1:], xj, y[j + 1:])
            Y[p0:pe, c] = y[:w]
        if pe == nn:
            break
        P = W[pe:nn, p0:pe].copy()              # the rows below, a row a thread
        for j in range(NB):
            P[:, j] = P[:, j] * dinv[j]
            for k in range(j + 1, NB):
                P[:, k] = _fma(-P[:, j], Dt[j, k], P[:, k])
        W[pe:nn, p0:pe] = P
        # global_update: the tiles' sums from zero over the panel's columns,
        # subtracted once; then the right-hand side's rows; Dg placed in W
        launches += 1
        nt = -(-(nn - pe) // T)
        S = np.zeros((nt * T, NB), f32)
        S[:nn - pe] = P
        acc = np.zeros((nt * T, nt * T), f32)
        for c in range(NB):
            acc = _fma(S[:, c][:, None], S[:, c][None, :], acc)
        for ti, tk in _global_tiles(nn, pe):
            ii, kk, ok = _tile_mask(nn, pe, ti, tk)
            W[ii[ok], kk[ok]] = W[ii[ok], kk[ok]] - acc[ii[ok] - pe, kk[ok] - pe]
        for c in range(m):
            s = np.zeros(nn - pe, f32)
            for j in range(NB):
                s = _fma(P[:, j], Y[p0 + j, c], s)
            Y[pe:, c] = Y[pe:, c] - s
        W[p0:pe, p0:pe] = np.where(np.tri(NB, dtype=bool), Dg.T, W[p0:pe, p0:pe])
    launches += 1                               # global_back, a column at a time
    X = np.stack([_back_rhs(lambda i, j: W[i, j], Y[:, c].copy()) for c in range(m)], 1)
    assert launches == global_launches(nn)
    return X


@pytest.mark.parametrize("nn,m", [(324, 1), (331, 1), (331, 3), (384, 1), (576, 1)])
def test_k4_global_schedule_matches_jax(nn, m):
    """K4's global path (mcptam_spd_solve_global's launches: the load, a
    panel and an update launch per NB columns, the back-substitution)
    beyond the shared range, at sizes that are and are not multiples of
    NB and TILE: within SPD_TOL (1e-3) of a float64 solve and of the JAX
    spd_solve."""
    assert route(nn, m) == "spd_solve_blocked_global"
    A, B = _spd_kappa(nn, nn + m)
    if m > 1:
        B = np.random.default_rng(nn).standard_normal((nn, m)).astype(np.float32)
    x = _global_emulate(A, B)
    x64 = np.linalg.solve(A.astype(np.float64), B.astype(np.float64))
    assert _rel(x, x64) < 1e-3
    assert _rel(x, np.asarray(j_spd_solve(jnp.asarray(A), jnp.asarray(B)))) < 1e-3


@pytest.mark.parametrize("nn", [324, 331, 384, 576])
def test_k4_global_tiles_cover_the_trailing_triangle(nn):
    """After every panel the update's tiles write each trailing lower
    entry (rows and columns >= pe, i >= k) exactly once and nothing above
    the diagonal, and its right-hand-side blocks take every row below the
    panel once; the workspace and launch count the wrapper allocates and
    expects."""
    T, NB = K4_GLOBAL_TILE, K4_GLOBAL_NB
    threads = (T // 4) ** 2                     # csrc/spd.cu UPDATE_THREADS
    for pe in range(NB, nn, NB):
        count = np.zeros((nn, nn), int)
        for ti, tk in _global_tiles(nn, pe):
            assert ti >= tk
            ii, kk, ok = _tile_mask(nn, pe, ti, tk)
            np.add.at(count, (ii[ok], kk[ok]), 1)
        lower = np.tril(np.ones((nn, nn), bool))
        lower[:pe] = False
        lower[:, :pe] = False
        assert np.all(count[lower] == 1) and np.all(count[~lower] == 0), pe
        blocks = -(-(nn - pe) // threads)
        rows = pe + np.arange(blocks * threads)
        assert np.array_equal(rows[rows < nn], np.arange(pe, nn))
    assert global_launches(nn) == 2 * -(-nn // NB) + 1
    assert global_work_floats(nn, 1) == nn * global_ld(nn) + NB * NB + nn


@pytest.mark.parametrize("nn,m,blocked,want", [
    (96, 1, True, "spd_solve_blocked"), (322, 1, True, "spd_solve_blocked"),
    (323, 1, True, "spd_solve_blocked_global"), (384, 1, True, "spd_solve_blocked_global"),
    (1536, 1, True, "spd_solve_blocked_global"), (96, 1, False, "spd_solve_simple"),
    (339, 1, False, "spd_solve_simple"), (340, 1, False, None),
    (3384, 1, True, "spd_solve_blocked_global"), (56000, 1, True, "spd_solve_blocked_global"),
    (56001, 1, True, None), (18666, 3, True, "spd_solve_blocked_global"), (18667, 3, True, None),
])
def test_spd_route(nn, m, blocked, want):
    """The wrapper's routing: K4 in shared memory up to n = 322, its
    global path beyond, up to where the back-substitution's right-hand
    sides and two 32 x 33 tiles fill shared memory (n m <= 56000); K5
    raises beyond n = 339 with a message that names the blocked
    default."""
    if want is None:
        with pytest.raises(ValueError, match="blocked default" if not blocked else "global"):
            route(nn, m, blocked)
    else:
        assert route(nn, m, blocked) == want
    if want == "spd_solve_blocked_global":
        assert shared_bytes(nn, m) > MAX_SHARED_BYTES >= shared_bytes_global(nn, m)
