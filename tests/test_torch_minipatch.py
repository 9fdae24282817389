"""Port parity of MiniPatch and its window gather: the plain version of
csrc/gather_unaligned.cu (K8) against a numpy transcription of the TPU
script's contract, and mini_template / mini_search / stability_filter /
filter_frame_candidates against the JAX package.

Tolerances: windows, found flags, positions and pruned candidate masks
exact; SSDs 1e-3 relative (the port sums the 81 terms in the JAX
package's order, but XLA may fuse them differently).  A window that does
not lie inside its image is masked in both packages, so templates and
regions are compared only where their ``ok`` flag holds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import C, H, W, jax_scene, n, t

from mcptam_tpu.map.keyframe import make_frame_features as j_features
from mcptam_tpu.ops import minipatch as jmp
from mcptam_tpu.ops.atlas import atlas_xoff
from mcptam_tpu_torch import convert
from mcptam_tpu_torch.ops import minipatch as pmp
from mcptam_tpu_torch.ops.gather_unaligned_kernel import gather_unaligned, gather_unaligned_reference


def _np_gather_unaligned(plane, rows, cols, G):
    """scripts/profile_gather.py:51-78 in numpy: pad the plane with GR = G
    zero rows and GC (G rounded up to 128) zero columns, clip the starts so
    that a (GR,GC) copy fits the padded plane, copy, keep the (G,G)
    corner."""
    GR, GC = G, ((G + 127) // 128) * 128
    padded = np.pad(plane, ((0, GR), (0, GC)))
    HH, AW = padded.shape
    rows = np.clip(rows, 0, HH - GR)
    cols = np.clip(cols, 0, AW - GC)
    return np.stack([padded[r:r + GR, c:c + GC][:G, :G] for r, c in zip(rows, cols)])


@pytest.mark.parametrize("G", [9, 29, 37])
def test_gather_unaligned_matches_the_script_contract(rng, G):
    plane = rng.standard_normal((3 * 60, 200)).astype(np.float32)
    K = 400
    rows = rng.integers(-2 * G, plane.shape[0] + G, K).astype(np.int32)
    cols = rng.integers(-2 * G, plane.shape[1] + G, K).astype(np.int32)
    rows[:4] = [-5, plane.shape[0] - 3, plane.shape[0], plane.shape[0] + 7]
    got = n(gather_unaligned(t(plane), t(rows), t(cols), G))
    ref = _np_gather_unaligned(plane, rows, cols, G)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(n(gather_unaligned_reference(t(plane), t(rows), t(cols), G)), ref)
    assert (got[2] == 0).all() and (got[3] == 0).all()   # overrun rows read zero


@pytest.fixture(scope="module")
def pair():
    """Level images of two consecutive frames and the current frame's
    candidates, as JAX features (numpy)."""
    frames = jax_scene()[-1]
    fn = jax.jit(j_features)
    jf = [jax.device_get(fn(jnp.asarray(f, jnp.float32))) for f in frames[:2]]
    return jf


def _level_image(feats, cam, level):
    xo = atlas_xoff(W)[level]
    return feats.atlas[cam, :H >> level, xo:xo + (W >> level)]


@pytest.mark.parametrize("level", [0, 2])
def test_mini_template_and_search_match(pair, level):
    prev, cur = pair
    img_p, img_c = _level_image(prev, 0, level), _level_image(cur, 0, level)
    xy = cur.cand_xy[level][0].astype(np.float32)
    xy = np.concatenate([xy, [[2.0, 3.0], [img_c.shape[1] - 3.0, 10.0]]]).astype(np.float32)
    jtpl = jax.jit(jax.vmap(jmp.mini_template, (None, 0)))
    jsearch = jax.jit(jax.vmap(jmp.mini_search, (None, 0, 0)))
    jt, jok = jtpl(jnp.asarray(img_c), jnp.asarray(xy))
    pt, pok = pmp.mini_template(t(img_c), t(xy))
    np.testing.assert_array_equal(n(pok), np.asarray(jok))
    assert not n(pok)[-2:].any()
    np.testing.assert_array_equal(n(pt)[n(pok)], np.asarray(jt)[np.asarray(jok)])
    # search the previous frame with the JAX templates (same input for both)
    jfound, jxy, jssd = jsearch(jnp.asarray(img_p), jt, jnp.asarray(xy))
    pfound, pxy, pssd = pmp.mini_search(t(img_p), t(np.asarray(jt)), t(xy))
    np.testing.assert_array_equal(n(pfound), np.asarray(jfound))
    np.testing.assert_array_equal(n(pxy), np.asarray(jxy))
    fin = np.isfinite(np.asarray(jssd))
    np.testing.assert_array_equal(np.isfinite(n(pssd)), fin)
    np.testing.assert_allclose(n(pssd)[fin], np.asarray(jssd)[fin], rtol=1e-3)
    assert np.asarray(jfound).sum() > 10


@pytest.mark.parametrize("level", [1, 3])
def test_stability_filter_matches(pair, level):
    prev, cur = pair
    for cam in range(C):
        args = (_level_image(prev, cam, level), _level_image(cur, cam, level),
                cur.cand_xy[level][cam], cur.cand_valid[level][cam])
        ref = np.asarray(jax.jit(jmp.stability_filter)(*map(jnp.asarray, args)))
        got = n(pmp.stability_filter(*map(t, args)))
        np.testing.assert_array_equal(got, ref)


def test_filter_frame_candidates_matches(pair):
    """All cameras and levels in one batch, read from the atlas planes."""
    prev, cur = pair
    ref = jax.jit(jmp.filter_frame_candidates)(
        jax.tree_util.tree_map(jnp.asarray, prev), jax.tree_util.tree_map(jnp.asarray, cur))
    got = pmp.filter_frame_candidates(convert.frame_features_from_numpy(prev, device="cpu"),
                                      convert.frame_features_from_numpy(cur, device="cpu"))
    kept = 0
    for l in range(len(got.cand_valid)):
        np.testing.assert_array_equal(n(got.cand_valid[l]), np.asarray(ref.cand_valid[l]))
        kept += int(n(got.cand_valid[l]).sum())
    before = sum(int(v.sum()) for v in cur.cand_valid)
    assert 0 < kept < before
    # everything but the candidate mask passes through unchanged
    np.testing.assert_array_equal(n(got.cand_xy[0]), cur.cand_xy[0])
