"""Port parity of the SBI path: templates, gradients, the ESM alignment
(the plain version of csrc/esm.cu) and the SE2 -> SO3 lift.

Tolerance: se2 within 3e-5, the reference's own bar for its ESM kernel
against the XLA path (config.py, tests/test_sbi_pallas.py): 9
Gauss-Newton iterations of f32 normal equations summed in another order.
Templates within 1e-4 grey levels, at the VGA half-sample chain and at
the two sizes that need the linear resize (480x752, 600x800): the
half-samples, the resize and the blur sum in another order than XLA's.

The CUDA kernel (csrc/esm.cu) runs only on the card (chip_smoke.py phase
3); here a numpy emulation of its iteration (each warp's band of rows
warped once, sums in the kernel's order: per lane over its pixels of the
band, a butterfly over the warp's lanes, the warps' partials in order,
then the 4x4 solve and SE2 update as every warp runs them) is held to the JAX kernel in interpret mode at the tracker's shape
(C = 4, 9 iterations) and the relocaliser's (C = 1, 12 iterations)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import H, W, C, jax_scene, n, np_get, t, traj_tangent

from mcptam_tpu.ops.sbi import esm_align as j_esm, make_sbi as j_make_sbi
from mcptam_tpu.ops.sbi import sbi_gradients as j_grad, se3_from_se2 as j_lift
from mcptam_tpu.ops.sbi_pallas import esm_align_all as j_esm_kernel
from mcptam_tpu_torch import backend, convert
from mcptam_tpu_torch.core.se3 import SE3
from mcptam_tpu_torch.io.synthetic import make_rig, render_rig
from mcptam_tpu_torch.ops.sbi import make_sbi, sbi_gradients, se3_from_se2
from mcptam_tpu_torch.ops.sbi_kernel import esm_align_all

SE2_TOL = 3e-5


@pytest.fixture(scope="module")
def sbi_pairs():
    """SBI templates of consecutive frames of the shared scene (numpy)."""
    frames = jax_scene()[-1].astype(np.float32)
    tmpl = np.asarray(j_make_sbi(jnp.asarray(frames)))          # (3,C,30,40)
    return tmpl


def test_make_sbi_and_gradients(sbi_pairs):
    frames = jax_scene()[-1].astype(np.float32)
    got = make_sbi(t(frames))
    np.testing.assert_allclose(n(got), sbi_pairs, rtol=0, atol=1e-4)
    for g, r in zip(sbi_gradients(t(sbi_pairs)), j_grad(jnp.asarray(sbi_pairs))):
        np.testing.assert_allclose(n(g), np.asarray(r), rtol=0, atol=1e-4)


@functools.lru_cache(maxsize=4)
def _rendered(h: int, w: int) -> np.ndarray:
    """Frames 0 and 1 of the parity trajectory rendered by a 2-camera rig
    at h x w: (2, 2, h, w) f32."""
    cams, cfb = make_rig(2, h, w, spread_deg=25.0, device="cpu")
    return np.stack([n(render_rig(cams, cfb, SE3.exp(t(traj_tangent(i))), 3.0, h, w))
                     for i in range(2)])


# (480, 752) halves to 30x47 and resizes its columns only; (600, 800)
# stops at 75x100 and resizes both axes
RESIZED = [(480, 752), (600, 800)]


@pytest.mark.parametrize("hw", RESIZED)
def test_make_sbi_resize_matches_jax(hw):
    frames = _rendered(*hw)
    got = make_sbi(t(frames))
    assert got.shape == frames.shape[:2] + (30, 40)
    np.testing.assert_allclose(n(got), np.asarray(j_make_sbi(jnp.asarray(frames))),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("hw", RESIZED)
def test_esm_runs_on_resized_sbis(hw):
    """One tracker ESM call (9 iterations) between the resized SBIs of two
    frames: finite, and within SE2_TOL of the JAX ESM on the JAX SBIs."""
    frames = _rendered(*hw)
    cur, tgt = n(make_sbi(t(frames[0]))), n(make_sbi(t(frames[1])))
    gx, gy = (n(g) for g in sbi_gradients(t(tgt)))
    se2, score = esm_align_all(*map(t, (cur, tgt, gx, gy)), n_iterations=9)
    assert np.isfinite(n(se2)).all() and np.isfinite(n(score)).all()
    j_cur, j_tgt = (j_make_sbi(jnp.asarray(f)) for f in frames)
    j_gx, j_gy = j_grad(j_tgt)
    se2_ref, _ = jax.vmap(lambda *a: j_esm(*a, n_iterations=9))(j_cur, j_tgt, j_gx, j_gy)
    np.testing.assert_allclose(n(se2), np.stack([np.asarray(v) for v in se2_ref], -1),
                               rtol=0, atol=SE2_TOL)


@pytest.mark.parametrize("iters", [1, 9])
def test_esm_matches_vmapped_reference_and_interpret(sbi_pairs, iters):
    cur, tgt = sbi_pairs[0], sbi_pairs[1]
    gx, gy = (np.asarray(a) for a in j_grad(jnp.asarray(tgt)))

    def ref_one(c, tt, a, b):
        se2, score = j_esm(c, tt, a, b, n_iterations=iters)
        return jnp.stack(se2), score

    se2_ref, score_ref = jax.vmap(ref_one)(*map(jnp.asarray, (cur, tgt, gx, gy)))
    se2_int, _ = j_esm_kernel(*map(jnp.asarray, (cur, tgt, gx, gy)),
                              n_iterations=iters, interpret=True)
    launches = backend.kernel_report()["esm_align_all"]
    se2, score = esm_align_all(*map(t, (cur, tgt, gx, gy)), n_iterations=iters)
    assert backend.kernel_report()["esm_align_all"] == launches
    np.testing.assert_allclose(n(se2), np.asarray(se2_ref), rtol=0, atol=SE2_TOL)
    np.testing.assert_allclose(n(se2), np.asarray(se2_int), rtol=0, atol=SE2_TOL)
    np.testing.assert_allclose(n(score), np.asarray(score_ref), rtol=1e-3, atol=1e-2)


def test_se3_from_se2(rng):
    cams_sbi = jax_scene()[2]
    se2 = np.zeros((C, 4), np.float32)
    th = rng.normal(size=C) * 0.05
    se2[:, 0], se2[:, 1] = np.cos(th), np.sin(th)
    se2[:, 2:] = rng.normal(size=(C, 2)) * 0.8
    ref = jax.vmap(lambda s, cam: j_lift(tuple(s), cam, cam))(
        jnp.asarray(se2), cams_sbi)
    pc = convert.camera_from_numpy(np_get(cams_sbi), device="cpu")
    got = se3_from_se2(t(se2), pc, pc)
    np.testing.assert_allclose(n(got), np.asarray(ref), rtol=0, atol=1e-5)


K3_THREADS = 256   # csrc/esm.cu THREADS
_ROWS, _COLS, _CX, _CY = 30, 40, np.float32(20.0), np.float32(15.0)


def _k3_warp_at(cur, c, s, tx, ty, xs, ys):
    """esm.cu warp_at over arrays of pixel coordinates, in f32."""
    f32 = np.float32
    xr = c * (xs - _CX) - s * (ys - _CY) + _CX + tx
    yr = s * (xs - _CX) + c * (ys - _CY) + _CY + ty
    xf = np.minimum(np.maximum(xr, f32(0)), f32(_COLS - 1))
    yf = np.minimum(np.maximum(yr, f32(0)), f32(_ROWS - 1))
    xi = np.minimum(np.floor(xf).astype(int), _COLS - 2)
    yi = np.minimum(np.floor(yf).astype(int), _ROWS - 2)
    wx, wy = xf - xi.astype(f32), yf - yi.astype(f32)
    p00, p01 = cur[yi, xi], cur[yi, xi + 1]
    p10, p11 = cur[yi + 1, xi], cur[yi + 1, xi + 1]
    one = f32(1)
    val = (one - wy) * ((one - wx) * p00 + wx * p01) + wy * ((one - wx) * p10 + wx * p11)
    ok = (xr >= 0) & (xr <= _COLS - 2) & (yr >= 0) & (yr <= _ROWS - 2)
    return val.astype(f32), ok


def _k3_solve4(H, b):
    """esm.cu solve4 in f32: H = L D L^T, one reciprocal a pivot."""
    f32 = np.float32
    L, W, r = np.zeros((4, 4), f32), np.zeros((4, 4), f32), np.zeros(4, f32)
    for i in range(4):
        for j in range(i):
            s = H[i][j]
            for k in range(j):
                s = f32(s - W[i, k] * L[j, k])
            W[i, j], L[i, j] = s, f32(s * r[j])
        d = H[i][i]
        for k in range(i):
            d = f32(d - W[i, k] * L[i, k])
        r[i] = f32(1) / np.maximum(d, f32(1e-20))
    y = np.zeros(4, f32)
    for i in range(4):
        s = b[i]
        for k in range(i):
            s = f32(s - L[i, k] * y[k])
        y[i] = s
    x = np.zeros(4, f32)
    for i in range(3, -1, -1):
        s = f32(y[i] * r[i])
        for k in range(i + 1, 4):
            s = f32(s - L[k, i] * x[k])
        x[i] = s
    return x


def _k3_emulate(cur, tgt, tgx, tgy, n_iterations):
    """esm_kernel for each camera, thread by thread (numpy over threads),
    in f32.  Returns (se2 (C,4), score (C,))."""
    f32 = np.float32
    nin, inner = (_ROWS - 2) * (_COLS - 2), _COLS - 2
    k = np.arange(nin)
    xs, ys = (1 + k % inner).astype(f32), (1 + k // inner).astype(f32)
    # warp w owns image rows 4w..4w+3; its lane l takes the band's inner
    # pixels p = l + 32 q, row-major, in order of q
    warps, band = K3_THREADS // 32, -(-_ROWS // (K3_THREADS // 32))
    warp = ys.astype(int) // band
    p = k - (np.maximum(band * warp, 1) - 1) * inner
    lane = np.arange(32)
    out, scores = [], []
    for cam in range(cur.shape[0]):
        cu_, tg = cur[cam].astype(f32), tgt[cam].astype(f32)
        gxt = tgx[cam][ys.astype(int), xs.astype(int)].astype(f32)
        gyt = tgy[cam][ys.astype(int), xs.astype(int)].astype(f32)
        tt = tg[ys.astype(int), xs.astype(int)]
        c, s, tx, ty, mo, score = f32(1), f32(0), f32(0), f32(0), f32(0), f32(np.inf)
        for _ in range(n_iterations):
            w0, v0 = _k3_warp_at(cu_, c, s, tx, ty, xs, ys)
            wl, vl = _k3_warp_at(cu_, c, s, tx, ty, xs - 1, ys)
            wr, vr = _k3_warp_at(cu_, c, s, tx, ty, xs + 1, ys)
            wu, vu = _k3_warp_at(cu_, c, s, tx, ty, xs, ys - 1)
            wd, vd = _k3_warp_at(cu_, c, s, tx, ty, xs, ys + 1)
            ok = v0 & vl & vr & vu & vd
            gx = f32(0.25) * ((wr - wl) + gxt)
            gy = f32(0.25) * ((wd - wu) + gyt)
            j3 = -(ys - _CY) * gx + (xs - _CX) * gy
            diff = w0 - tt + mo
            J = [gx, gy, j3, np.ones_like(gx)]
            terms = [J[i] * J[j] for i in range(4) for j in range(i, 4)]
            terms += [J[i] * diff for i in range(4)] + [diff * diff]
            terms = np.where(ok[:, None], np.stack(terms, -1), f32(0)).astype(f32)   # (nin, 15)
            acc = np.zeros((warps, 32, 16), f32)
            for q in range(p.max() // 32 + 1):         # a lane's pixels in order
                sel = p // 32 == q
                acc[warp[sel], p[sel] % 32, :15] += terms[sel]
            for bit in (16, 8, 4, 2, 1):               # the butterfly's pairings
                acc = acc + acc[:, lane ^ bit]
            tot = np.zeros(15, f32)
            for w in range(warps):                     # the warps' partials in order
                tot = tot + acc[w, 0, :15]
            H = np.zeros((4, 4), f32)
            q = 0
            for i in range(4):
                for j in range(i, 4):
                    H[i, j] = H[j, i] = tot[q]
                    q += 1
            H[np.arange(4), np.arange(4)] += f32(1e-6)
            upd = _k3_solve4(H, tot[10:14])
            dth = -upd[2]
            cuu, suu = np.cos(dth).astype(f32), np.sin(dth).astype(f32)
            c, s, tx, ty = (c * cuu - s * suu, s * cuu + c * suu,
                            c * (-upd[0]) - s * (-upd[1]) + tx,
                            s * (-upd[0]) + c * (-upd[1]) + ty)
            mo, score = mo - upd[3], tot[14]
        out.append([c, s, tx, ty])
        scores.append(score)
    return np.array(out, f32), np.array(scores, f32)


@pytest.mark.parametrize("cams,iters", [(4, 9), (1, 12)])
def test_k3_schedule_matches_jax_kernel(sbi_pairs, cams, iters):
    """The kernel's iteration (one barrier, tail on every warp) aligns as
    the JAX kernel does: the tracker's four cameras (frame pairs 0-1 and
    1-2 of the shared scene's two cameras) and the relocaliser's one."""
    cur = np.concatenate([sbi_pairs[0], sbi_pairs[1]])[:cams]
    tgt = np.concatenate([sbi_pairs[1], sbi_pairs[2]])[:cams]
    gx, gy = (np.asarray(a) for a in j_grad(jnp.asarray(tgt)))
    se2_int, score_int = j_esm_kernel(*map(jnp.asarray, (cur, tgt, gx, gy)),
                                      n_iterations=iters, interpret=True)
    se2, score = _k3_emulate(cur, tgt, gx, gy, iters)
    np.testing.assert_allclose(se2, np.asarray(se2_int), rtol=0, atol=SE2_TOL)
    np.testing.assert_allclose(score, np.asarray(score_int), rtol=1e-3, atol=1e-2)
