"""Port parity of the SBI path: templates, gradients, the ESM alignment
(the plain version of csrc/esm.cu) and the SE2 -> SO3 lift.

Tolerance: se2 within 3e-5, the reference's own bar for its ESM kernel
against the XLA path (config.py, tests/test_sbi_pallas.py): 9
Gauss-Newton iterations of f32 normal equations summed in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import H, W, C, jax_scene, n, np_get, t

from mcptam_tpu.ops.sbi import esm_align as j_esm, make_sbi as j_make_sbi
from mcptam_tpu.ops.sbi import sbi_gradients as j_grad, se3_from_se2 as j_lift
from mcptam_tpu.ops.sbi_pallas import esm_align_all as j_esm_kernel
from mcptam_tpu_torch import backend, convert
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
