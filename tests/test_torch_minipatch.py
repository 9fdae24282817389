"""Port parity of MiniPatch and its window gather: the plain version of
csrc/gather_unaligned.cu (K8) against a numpy transcription of the TPU
script's contract; mini_template / mini_search / stability_filter /
filter_frame_candidates against the JAX package; and the plain version of
csrc/minipatch.cu (the fused round trip, ``stability_reference``) against
the JAX package's mini_template / mini_search composition, search by
search, with candidates moved onto every level's border.

Tolerances: windows, found flags, positions and pruned candidate masks
exact; SSDs 1e-3 relative (the port sums the 81 terms in the JAX
package's order, but XLA may fuse them differently).  A window that does
not lie inside its image is masked in both packages, so templates and
regions are compared only where their ``ok`` flag holds."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import C, H, W, jax_scene, n, t

from mcptam_tpu.map.keyframe import make_frame_features as j_features
from mcptam_tpu.ops import minipatch as jmp
from mcptam_tpu.ops.atlas import atlas_xoff
from mcptam_tpu_torch import backend, convert
from mcptam_tpu_torch.ops import minipatch as pmp
from mcptam_tpu_torch.ops import minipatch_kernel as pmk
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


# border distances (level px) at which candidates are placed: inside the
# 4-px template margin, inside the 14-px region margin, and where only the
# return search's region leaves the image
BORDER_DISTANCES = (0, 1, 2, 3, 4, 5, 9, 13, 14, 15, 19, 23, 24, 25)


def _at_borders(feats):
    """feats (JAX, numpy leaves) with the first candidates of every camera
    and level moved to BORDER_DISTANCES from each of the four image edges
    and made valid."""
    xy, valid = [], []
    for l, (cxy, cv) in enumerate(zip(feats.cand_xy, feats.cand_valid)):
        h, w = H >> l, W >> l
        pts = [p for d in BORDER_DISTANCES
               for p in ((d, h // 2), (w - 1 - d, h // 3), (w // 3, d), (w // 2, h - 1 - d))]
        pts = np.asarray(pts[:cxy.shape[1]], np.int32)
        cxy, cv = cxy.copy(), cv.copy()
        cxy[:, :len(pts)] = pts
        cv[:, :len(pts)] = True
        xy.append(cxy)
        valid.append(cv)
    return feats.replace(cand_xy=tuple(xy), cand_valid=tuple(valid))


@pytest.fixture(scope="module")
def far_pair():
    """JAX features of frames 0 and 2 of the scene (twice the motion of
    ``pair``), the current frame's candidates moved onto the borders."""
    frames = jax_scene()[-1]
    fn = jax.jit(j_features)
    prev, cur = (jax.device_get(fn(jnp.asarray(f, jnp.float32))) for f in (frames[0], frames[2]))
    return prev, _at_borders(cur)


@functools.lru_cache(maxsize=None)
def _jax_round_trip():
    """The JAX package's stability_filter, search by search: (t_ok, tp_ok,
    found, xy, ssd) of both searches, vmapped over cameras and candidates."""
    def per_cand(prev_img, cur_img, xy):
        xy = xy.astype(jnp.float32)
        t_cur, t_ok = jmp.mini_template(cur_img, xy)
        f1, xy_prev, s1 = jmp.mini_search(prev_img, t_cur, xy)
        t_prev, tp_ok = jmp.mini_template(prev_img, xy_prev)
        f2, xy_back, s2 = jmp.mini_search(cur_img, t_prev, xy_prev)
        return t_ok, tp_ok, jnp.stack([f1, f2]), jnp.stack([xy_prev, xy_back]), jnp.stack([s1, s2])

    per_image = jax.vmap(per_cand, (None, None, 0))
    return jax.jit(jax.vmap(per_image))


def _plain_round_trip(prev, cur):
    """stability_reference over every camera and level of a pair, as
    filter_frame_candidates lays them out; returns the RoundTrip as numpy,
    split by level into (C,K_l,...) arrays."""
    C_, H_, AW = cur.atlas.shape
    sizes = tuple(v.shape[1] for v in cur.cand_valid)
    desc = pmk.level_descriptors(C_, H_, AW, sizes, torch.device("cpu"))
    xy = np.concatenate([x.reshape(-1, 2) for x in cur.cand_xy])
    valid = np.concatenate([v.reshape(-1) for v in cur.cand_valid])
    rt = pmk.stability_reference(t(prev.atlas.reshape(C_ * H_, AW)),
                                 t(cur.atlas.reshape(C_ * H_, AW)), desc, t(xy), t(valid))
    cuts = np.cumsum([C_ * k for k in sizes])[:-1]
    out = []
    for l, k in enumerate(sizes):
        lv = {}
        for name, a in rt._asdict().items():
            a = n(a)
            a = np.split(a, cuts, axis=-1 if a.ndim <= 2 else 1)[l]
            lv[name] = a.reshape(a.shape[:-1] + (C_, k)) if a.ndim <= 2 else a.reshape(2, C_, k, 2)
        out.append(lv)
    return out


@pytest.mark.parametrize("which", ["pair", "far_pair"])
@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_stability_reference_matches_jax_searches(request, which, level):
    """Each search of the round trip, against the JAX composition: found
    flags and positions exact, SSDs within 1e-3 relative, wherever the
    search's template is read from inside the image (outside it the JAX
    package clamps the window, K8 zero-fills it).  The return search is
    compared wherever both templates hold, and ``ran`` must be the JAX
    package's valid & t_ok & found & tp_ok."""
    prev, cur = request.getfixturevalue(which)
    got = _plain_round_trip(prev, cur)[level]
    imgs = [np.stack([_level_image(f, cam, level) for cam in range(C)]) for f in (prev, cur)]
    t_ok, tp_ok, found, xy, ssd = (np.asarray(a) for a in _jax_round_trip()(
        jnp.asarray(imgs[0]), jnp.asarray(imgs[1]), jnp.asarray(cur.cand_xy[level])))
    valid = cur.cand_valid[level]
    found, xy, ssd = np.moveaxis(found, -1, 0), np.moveaxis(xy, -2, 0), np.moveaxis(ssd, -1, 0)
    np.testing.assert_array_equal(got["ran"][0], valid)
    np.testing.assert_array_equal(got["ran"][1], valid & t_ok & found[0] & tp_ok)
    for i, where in enumerate((valid & t_ok, valid & t_ok & tp_ok)):
        np.testing.assert_array_equal(got["found"][i][where], found[i][where])
        np.testing.assert_array_equal(got["xy"][i][where], xy[i][where])
        fin = np.isfinite(ssd[i]) & where
        np.testing.assert_array_equal(np.isfinite(got["ssd"][i]) & where, fin)
        np.testing.assert_allclose(got["ssd"][i][fin], ssd[i][fin], rtol=1e-3)
    if level < 3:   # a 29x29 region fits a 30x40 level-3 image at two rows only
        assert (valid & t_ok & found[0]).sum() > 10 and got["ran"][1].sum() > 10
    if which == "far_pair":     # the border candidates reach every branch
        assert (valid & ~t_ok).any() and (valid & t_ok & ~found[0]).any()


def test_border_and_shift_kept_matches_jax(far_pair):
    """filter_frame_candidates on frames two apart with candidates on every
    border: JAX's pruned mask exactly, with some kept and some pruned."""
    prev, cur = far_pair
    ref = jax.jit(jmp.filter_frame_candidates)(
        jax.tree_util.tree_map(jnp.asarray, prev), jax.tree_util.tree_map(jnp.asarray, cur))
    got = pmp.filter_frame_candidates(convert.frame_features_from_numpy(prev, device="cpu"),
                                      convert.frame_features_from_numpy(cur, device="cpu"))
    for l in range(len(got.cand_valid)):
        np.testing.assert_array_equal(n(got.cand_valid[l]), np.asarray(ref.cand_valid[l]))
    kept = sum(int(n(v).sum()) for v in got.cand_valid)
    assert 0 < kept < sum(int(v.sum()) for v in cur.cand_valid)


def test_stability_rounds_half_to_even(pair):
    """Half-integer candidates round half to even in both packages."""
    prev, cur = pair
    img_p, img_c = _level_image(prev, 0, 1), _level_image(cur, 0, 1)
    xy = cur.cand_xy[1][0].astype(np.float32) + np.float32(0.5)
    valid = cur.cand_valid[1][0]
    ref = np.asarray(jax.jit(jmp.stability_filter)(*map(jnp.asarray, (img_p, img_c, xy, valid))))
    np.testing.assert_array_equal(n(pmp.stability_filter(t(img_p), t(img_c), t(xy), t(valid))), ref)
    assert ref.any()


def test_level_descriptors_follow_the_atlas():
    """The cached (row0, col0, h, w) of every candidate: camera rows,
    atlas_xoff and the level sizes, in filter_frame_candidates' order."""
    AW = pmk.atlas_xoff(W)[-1] + (W >> 3)
    counts = (5, 4, 3, 2)
    desc = pmk.level_descriptors(C, H, AW, counts, torch.device("cpu"))
    assert desc.dtype == torch.int32 and desc.shape == (C * sum(counts), 4)
    assert pmk.level_descriptors(C, H, AW, counts, torch.device("cpu")) is desc
    want = [(cam * H, atlas_xoff(W)[l], H >> l, W >> l)
            for l, k in enumerate(counts) for cam in range(C) for _ in range(k)]
    np.testing.assert_array_equal(n(desc), np.asarray(want))


def _search_args(pair):
    prev, cur = pair
    C_, H_, AW = cur.atlas.shape
    sizes = tuple(v.shape[1] for v in cur.cand_valid)
    return [t(prev.atlas.reshape(C_ * H_, AW)), t(cur.atlas.reshape(C_ * H_, AW)),
            pmk.level_descriptors(C_, H_, AW, sizes, torch.device("cpu")),
            t(np.concatenate([x.reshape(-1, 2) for x in cur.cand_xy])),
            t(np.concatenate([v.reshape(-1) for v in cur.cand_valid]))]


def test_stability_search_takes_the_plain_version_on_the_cpu(pair):
    args = _search_args(pair)
    before = backend.kernel_report()["stability_filter"]
    got = pmk.stability_search(*args)
    assert backend.kernel_report()["stability_filter"] == before
    want = pmk.stability_reference(*args)
    for a, b in zip(got, want):
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.parametrize("bad", ["plane_f64", "planes_differ", "desc_i64", "desc_shape",
                                 "valid_u8", "xy_shape", "meta"])
def test_stability_search_rejects_what_it_does_not_take(pair, bad):
    prev, cur, desc, xy, valid = _search_args(pair)
    if bad == "plane_f64":
        prev = prev.double()
    elif bad == "planes_differ":
        cur = cur[:-1]
    elif bad == "desc_i64":
        desc = desc.to(torch.int64)
    elif bad == "desc_shape":
        desc = desc[:-1]
    elif bad == "valid_u8":
        valid = valid.to(torch.uint8)
    elif bad == "xy_shape":
        xy = xy[:, :1]
    else:
        prev, cur, desc, xy, valid = (a.to("meta") for a in (prev, cur, desc, xy, valid))
    with pytest.raises(ValueError):
        pmk.stability_search(prev, cur, desc, xy, valid)
