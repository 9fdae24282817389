"""Port parity of the FAST front-end (the plain version of csrc/fast.cu),
the adaptive thresholds, candidate cutoffs and candidate lists, and the
whole feature front-end.

Tolerance: exact.  Scores are min/max of pixel differences, histograms are
counts, thresholds are integers and candidates are indices — for integer
images (and their dyadic pyramid levels) every value is exact in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import H, W, C, jax_scene, n, t

from mcptam_tpu.map.keyframe import make_frame_features as j_features
from mcptam_tpu.ops import fast as jfast
from mcptam_tpu.ops.fast_pallas import fast_frontend as j_kernel
from mcptam_tpu.ops.fast_pallas import fast_frontend_reference as j_reference
from mcptam_tpu_torch import backend
from mcptam_tpu_torch.map.keyframe import make_frame_features as p_features
from mcptam_tpu_torch.ops import fast as pfast
from mcptam_tpu_torch.ops.fast_kernel import fast_frontend, fast_frontend_reference
from mcptam_tpu_torch.ops.pyramid import build_pyramid


def _image(rng, shape):
    return np.round(rng.random(shape) * 255.0).astype(np.float32)


def _equal(a, b):
    np.testing.assert_array_equal(n(a), n(b))


@pytest.mark.parametrize("shape", [(2, 64, 128), (1, 60, 80), (3, 48, 256)])
def test_frontend_matches_reference_and_interpret(rng, shape):
    img = _image(rng, shape)
    launches = backend.kernel_report()["fast_frontend"]
    got = fast_frontend(t(img))
    # a CPU tensor takes the plain version and launches nothing
    assert backend.kernel_report()["fast_frontend"] == launches
    ref = jax.jit(j_reference)(jnp.asarray(img))
    interp = j_kernel(jnp.asarray(img), interpret=True)
    for g, r, k in zip(got, ref, interp):
        _equal(g, r)
        _equal(g, k)


def test_frontend_on_pyramid_levels():
    """Dyadic pyramid levels of a real uint8 frame (fractional pixel
    values), exact.  Levels 2-3 here; test_frame_features_match covers
    every level through the corner atlas and the candidates."""
    frames = jax_scene()[-1]
    img = frames[0].astype(np.float32)
    for lvl in build_pyramid(t(img))[2:]:
        ref = jax.jit(j_reference)(jnp.asarray(n(lvl)))
        for g, r in zip(fast_frontend_reference(lvl), ref):
            _equal(g, r)


def test_thresholds_and_cutoffs(rng):
    img = _image(rng, (2, 96, 128))
    _, _, freq, freq_nm = j_reference(jnp.asarray(img))
    th_j = jfast.adaptive_threshold_from_freq(freq, 96 * 128)
    th_p = pfast.adaptive_threshold_from_freq(t(freq), 96 * 128)
    _equal(th_p, th_j)
    for k in (16, 64, 512):
        _equal(pfast.cutoff_from_freq(t(freq_nm), th_p, k),
               jfast.cutoff_from_freq(freq_nm, th_j, k))


@pytest.mark.parametrize("k", [32, 200])
def test_select_corners_cutoff(rng, k):
    img = _image(rng, (2, 64, 96))
    _, nm, _, freq_nm = j_reference(jnp.asarray(img))
    mask = rng.random((2, 64, 96)) > 0.2
    th = jnp.asarray([9.0, 14.0])
    cut = jfast.cutoff_from_freq(freq_nm, th, k)
    ref = jax.vmap(lambda a, m, c, f: jfast.select_corners_cutoff(a, m, c, k, floor=f))(
        nm, jnp.asarray(mask), cut, th)
    got = pfast.select_corners_cutoff(t(nm), t(mask), t(cut), k, floor=t(th))
    for g, r in zip(got, ref):
        _equal(g, r)


def test_frame_features_match():
    """make_frame_features on identical uint8 frames: pyramid atlas,
    corner atlas, thresholds, counts and candidates exact; the SBI (a
    Gaussian blur, summed in another order) within 1e-4 grey levels."""
    frames = jax_scene()[-1]
    ref = jax.device_get(jax.jit(j_features)(jnp.asarray(frames[1])))
    got = p_features(t(frames[1]))
    for name in ("atlas", "corner_atlas", "thresholds", "corner_counts"):
        _equal(getattr(got, name), getattr(ref, name))
    for name in ("cand_xy", "cand_score", "cand_valid"):
        for g, r in zip(getattr(got, name), getattr(ref, name)):
            _equal(g, r)
    for name in ("sbi", "sbi_gx", "sbi_gy"):
        np.testing.assert_allclose(n(getattr(got, name)), getattr(ref, name),
                                   rtol=0, atol=1e-4)
    assert got.atlas.shape == (C, H, ref.atlas.shape[-1])
