"""Port parity of the half-sample (the plain version of csrc/halfsample.cu,
K6/K7), the pyramid, glare and static masks in the feature front-end, and
the entry points' device default.

Tolerance: exact.  The half-sample sums in the same order in both packages,
so it is bit-identical on any f32 input; masks are booleans and the
candidate lists are indices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import H, W, C, jax_scene, n, t

from mcptam_tpu.map.keyframe import glare_mask as j_glare_mask
from mcptam_tpu.map.keyframe import make_frame_features as j_features
from mcptam_tpu.ops.pyramid import build_pyramid as j_pyramid
from mcptam_tpu.ops.pyramid import half_sample as j_half_sample
from mcptam_tpu_torch.map.keyframe import glare_mask as p_glare_mask
from mcptam_tpu_torch.map.keyframe import make_frame_features as p_features
from mcptam_tpu_torch.ops.pyramid import build_pyramid, half_sample, half_sample_reference


@pytest.mark.parametrize("shape", [(4, 48, 64), (2, 31, 45), (3, 2, 2), (1, 7, 10)])
def test_half_sample_matches_on_random_f32(rng, shape):
    """Random f32 of both signs and many magnitudes, odd sizes cropped."""
    x = (rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 4, shape)).astype(np.float32)
    got = half_sample(t(x))
    ref = np.asarray(jax.jit(j_half_sample)(jnp.asarray(x)))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(n(got), ref)
    np.testing.assert_array_equal(n(half_sample_reference(t(x))), ref)


def test_pyramid_matches_on_uint8_frames():
    frames = jax_scene()[-1]
    for f in frames:
        got = build_pyramid(t(f))
        ref = jax.jit(j_pyramid)(jnp.asarray(f))
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(n(a), np.asarray(b))


def _glare_frame():
    """A rendered frame with saturated blobs (glare) in both cameras."""
    img = jax_scene()[-1][0].copy()
    img[0, 40:60, 100:140] = 255
    img[1, 150:170, 30:50] = 250
    img[1, 0:6, 0:8] = 255          # a corner blob: the dilation wraps around
    return img


def test_glare_mask_matches():
    img = _glare_frame().astype(np.float32)
    got = n(p_glare_mask(t(img)))
    np.testing.assert_array_equal(got, np.asarray(jax.jit(j_glare_mask)(jnp.asarray(img))))
    assert (~got).sum() > 1000


def _static_masks():
    """A 32-px bottom band on every camera and a left block on camera 1."""
    m = np.ones((C, H, W), bool)
    m[:, H - 32:, :] = False
    m[1, :, :48] = False
    return m


@pytest.mark.parametrize("static,glare", [(True, False), (False, True), (True, True)])
def test_masked_frame_features_match(static, glare):
    img = _glare_frame()
    masks = _static_masks() if static else None
    jf = jax.jit(lambda i, m: j_features(i, static_masks=m, glare_masking=glare))(
        jnp.asarray(img, jnp.float32), None if masks is None else jnp.asarray(masks))
    pf = p_features(t(img), static_masks=None if masks is None else t(masks),
                    glare_masking=glare)
    np.testing.assert_array_equal(n(pf.thresholds), np.asarray(jf.thresholds))
    np.testing.assert_array_equal(n(pf.corner_counts), np.asarray(jf.corner_counts))
    np.testing.assert_array_equal(n(pf.corner_atlas), np.asarray(jf.corner_atlas))
    for l in range(len(pf.cand_xy)):
        for name in ("cand_xy", "cand_valid", "cand_score"):
            np.testing.assert_array_equal(n(getattr(pf, name)[l]),
                                          np.asarray(getattr(jf, name)[l]), err_msg=name)
    if static:
        # no candidate in a masked region, at any level
        for l in range(len(pf.cand_xy)):
            xy, ok = n(pf.cand_xy[l]), n(pf.cand_valid[l])
            assert not (ok & (xy[..., 1] >= (H - 32) >> l)).any()
            assert not (ok[1] & (xy[1, :, 0] < 48 >> l)).any()
    unmasked = p_features(t(img))
    assert int(pf.corner_counts.sum()) < int(unmasked.corner_counts.sum())


def test_entry_points_default_to_the_card():
    """make_rig and the loaders run on CUDA unless the caller asks for the
    CPU; with no CUDA (this machine) the default raises, with no fallback."""
    from mcptam_tpu_torch import convert
    from mcptam_tpu_torch.io.synthetic import make_rig
    from mcptam_tpu_torch.tracker.tracker import create_tracker_state

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    with pytest.raises((RuntimeError, AssertionError)):
        make_rig(2, 240, 320)
    with pytest.raises((RuntimeError, AssertionError)):
        create_tracker_state(2)
    with pytest.raises((RuntimeError, AssertionError)):
        convert.se3_from_numpy({"R": np.eye(3, dtype=np.float32),
                                "t": np.zeros(3, np.float32)})
    cams, cfb = make_rig(2, 240, 320, device="cpu")
    assert cfb.t.device.type == "cpu" and cams.center.device.type == "cpu"
