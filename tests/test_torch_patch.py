"""Port parity of the batched patch search: window gathers (the plain
version of csrc/gather.cu), warped templates, the ZMSSD search (the plain
version of csrc/search.cu, ``search_patches_reference``) and the subpixel
refinement, on the fine-stage and coarse-stage pairs of a real tracking
frame.

Tolerances:
  * gathers: exact (copies);
  * templates: 1e-3 grey levels (bilinear weights summed in another order);
  * search: the found flags and integer best offsets agree on >= 99% of
    the pairs; every disagreement is a near-tie (the two packages' best
    ZMSSD within 1e-3 relative), since the cross-correlation sums in
    another order than XLA's; agreeing pairs' subpixel positions within
    1e-3 px."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import H, W, C, jax_scene, n, t, traj_tangent

from mcptam_tpu.core.se3 import SE3 as JSE3
from mcptam_tpu.map.keyframe import make_frame_features as j_features
from mcptam_tpu.ops import batch_patch as jbp
from mcptam_tpu.ops.atlas import level_size_arrays as j_level_hw
from mcptam_tpu.ops.patch import pack_corner_atlas as j_pack
from mcptam_tpu.tracker import tracker as jtr
from mcptam_tpu_torch import backend
from mcptam_tpu_torch.ops import batch_patch as pbp
from mcptam_tpu_torch.ops.atlas import level_size_arrays as p_level_hw
from mcptam_tpu_torch.ops.gather_kernel import gather_windows, gather_windows_reference
from mcptam_tpu_torch.ops.patch import PACK_CORNER
from mcptam_tpu_torch.ops.search_kernel import WSZ, search_patches_reference

K = 200
RANGE = 10  # the fine stage's first-frame radius (TrackerConfig.fine_range_first)
# the coarse stage (TrackerConfig): 60 pairs, a 30 px level-0 radius, at
# levels >= 2 searched over ceil(30 / 4) = 8 level pixels, 8 subpixel its
COARSE_K, COARSE_RANGE, COARSE_MAX_R, COARSE_ITS = 60, 8, 30.0, 8


def _stage_pairs(coarse: bool):
    """Stage inputs of frame 1 under its true pose, from the JAX tracker's
    own PVS and pair selection (numpy): the fine stage's K pairs, or the
    coarse stage's COARSE_K pairs at levels >= 2."""
    cams, cfb, _, ms, frames = jax_scene()
    feats = jax.jit(j_features)(jnp.asarray(frames[1]))
    pose = JSE3.exp(jnp.asarray(traj_tangent(1)))
    pvs = jtr.compute_pvs(ms, cams, pose)
    N = ms.points.capacity
    valid = pvs["valid"] & (pvs["level"] >= 2) if coarse else pvs["valid"]
    idx, ok = jtr._select_pairs(valid, jtr._pair_perm(C, N), COARSE_K if coarse else K)
    cam, pt = idx // N, idx % N
    pts = ms.points
    out = dict(
        cam=cam, pt=pt, ok=ok, uv=pvs["uv"].reshape(-1, 2)[idx],
        warp=pvs["warp"].reshape(-1, 2, 2)[idx],
        level=pvs["level"].reshape(-1)[idx],
        src_win=pts.src_window[pt], src_ok=pts.src_window_ok[pt],
        src_level=pts.src_level[pt], center=pts.center_xy[pt],
        fixed=pts.fixed[pt],
        packed=j_pack(feats.atlas, feats.corner_atlas),
        mkf_atlas=ms.mkfs.atlas,
    )
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def pairs():
    return _stage_pairs(coarse=False)


@pytest.fixture(scope="module")
def coarse_pairs():
    return _stage_pairs(coarse=True)


def _i64(a):
    return t(a).long()


def test_gather_windows_is_a_copy(rng):
    plane = (rng.random((90, 70)) * 255).astype(np.float32)
    rows = rng.integers(-5, 70, 40)
    cols = rng.integers(-5, 60, 40)
    launches = backend.kernel_report()["gather_windows"]
    got = gather_windows(t(plane), t(rows), t(cols), 17)
    assert backend.kernel_report()["gather_windows"] == launches
    r0 = np.clip(rows, 0, 90 - 17)
    c0 = np.clip(cols, 0, 70 - 17)
    want = np.stack([plane[r:r + 17, c:c + 17] for r, c in zip(r0, c0)])
    np.testing.assert_array_equal(n(got), want)
    np.testing.assert_array_equal(
        n(gather_windows_reference(t(plane.astype(np.uint8)), t(rows), t(cols), 17)),
        want.astype(np.uint8).astype(np.float32))


@pytest.mark.parametrize("G", [35, 31])
def test_gather_windows3_matches(pairs, rng, G):
    y0 = rng.integers(-20, H, K)
    x0 = rng.integers(-20, W // 2, K)
    ref_w, ref_ok = jbp.gather_windows3(
        jnp.asarray(pairs["packed"]), jnp.asarray(pairs["cam"]),
        jnp.asarray(pairs["level"]), jnp.asarray(y0), jnp.asarray(x0), G)
    got_w, got_ok = pbp.gather_windows3(
        t(pairs["packed"]), _i64(pairs["cam"]), _i64(pairs["level"]),
        _i64(y0), _i64(x0), G)
    np.testing.assert_array_equal(n(got_w), np.asarray(ref_w))
    np.testing.assert_array_equal(n(got_ok), np.asarray(ref_ok))


def test_gather_windows4_uint8_matches(pairs, rng):
    M = pairs["mkf_atlas"].shape[0]
    mkf = rng.integers(0, M, K)
    y0 = rng.integers(-20, H, K)
    x0 = rng.integers(-20, W // 2, K)
    args = (pairs["cam"], pairs["level"], y0, x0)
    ref_w, ref_ok = jbp.gather_windows4(
        jnp.asarray(pairs["mkf_atlas"]), jnp.asarray(mkf),
        *map(jnp.asarray, args), 26)
    got_w, got_ok = pbp.gather_windows4(
        t(pairs["mkf_atlas"]), _i64(mkf), *map(_i64, args), 26)
    np.testing.assert_array_equal(n(got_w), np.asarray(ref_w))
    np.testing.assert_array_equal(n(got_ok), np.asarray(ref_ok))


def _templates(pairs):
    ref = jbp.make_warped_templates(
        jnp.asarray(pairs["src_win"]), jnp.asarray(pairs["src_ok"]),
        j_level_hw(H, W), jnp.asarray(pairs["src_level"]),
        jnp.asarray(pairs["center"]), jnp.asarray(pairs["warp"]),
        jnp.asarray(pairs["level"]))
    got = pbp.make_warped_templates(
        t(pairs["src_win"]), t(pairs["src_ok"]), p_level_hw(H, W, "cpu"),
        _i64(pairs["src_level"]), t(pairs["center"]), t(pairs["warp"]),
        _i64(pairs["level"]))
    return ref, got


def test_make_warped_templates(pairs):
    (tj, okj), (tp, okp) = _templates(pairs)
    np.testing.assert_array_equal(n(okp), np.asarray(okj))
    np.testing.assert_allclose(n(tp), np.asarray(tj), rtol=0, atol=1e-3)
    assert np.asarray(okj).sum() > K // 2


def _check_search(pairs, R, max_r, its, port_search):
    """JAX find_patches + subpix_refine_region against the port's search
    (``port_search``, find_patches' signature) + subpix_refine_region on
    the same templates, under the module's bar.  Returns the port's aux."""
    (tj, okj), _ = _templates(pairs)
    tmpl = np.asarray(tj)
    fj, pj, sj, auxj = jbp.find_patches(
        jnp.asarray(pairs["packed"]), j_level_hw(H, W), jnp.asarray(pairs["cam"]),
        jnp.asarray(pairs["level"]), jnp.asarray(tmpl), jnp.asarray(pairs["uv"]),
        R, jnp.asarray(max_r), exhaustive=jnp.asarray(pairs["fixed"]))
    rj, cj = jbp.subpix_refine_region(auxj, j_level_hw(H, W),
                                      jnp.asarray(pairs["level"]),
                                      jnp.asarray(tmpl), pj, its)
    hw = p_level_hw(H, W, "cpu")
    fp, pp, sp, auxp = port_search(
        t(pairs["packed"]), hw, _i64(pairs["cam"]), _i64(pairs["level"]),
        t(tmpl), t(pairs["uv"]), R, t(np.float32(max_r)),
        exhaustive=t(pairs["fixed"]))
    rp, cp = pbp.subpix_refine_region(auxp, hw, _i64(pairs["level"]), t(tmpl),
                                      pp, its)
    fj, pj, sj, rj, cj = map(np.asarray, (fj, pj, sj, rj, cj))
    fp, pp, sp, rp, cp = map(n, (fp, pp, sp, rp, cp))

    Kp = fj.shape[0]
    agree = (fp == fj) & np.all(pp == pj, -1)
    assert agree.mean() >= 0.99, agree.mean()
    near_tie = np.isclose(sp, sj, rtol=1e-3, atol=1e-3)
    assert np.all(near_tie[~agree]), (sp[~agree], sj[~agree])
    assert fj.sum() > Kp // 4
    both = agree & fj
    np.testing.assert_array_equal(cp[both], cj[both])
    conv = both & cj
    np.testing.assert_allclose(rp[conv], rj[conv], rtol=0, atol=1e-3)
    return auxp


def test_find_patches_and_subpix(pairs):
    _check_search(pairs, RANGE, 10.0, 10, pbp.find_patches)


@pytest.mark.parametrize("stage,R,max_r", [
    ("coarse", COARSE_RANGE, COARSE_MAX_R), ("fine", RANGE, 10.0), ("fine", RANGE, 5.0),
    ("fine", 5, 5.0),
])
def test_search_patches_reference_matches_jax(pairs, coarse_pairs, stage, R, max_r):
    """The fused kernel's plain version at the coarse shape (K = 60, R = 8,
    S = 17, G2 = 31) and the fine ones (R = 10 at the first frame's and at
    the later frames' radius; R = 5: S = 11, G2 = 25)."""
    p, its = (coarse_pairs, COARSE_ITS) if stage == "coarse" else (pairs, 10)
    aux = _check_search(p, R, max_r, its, search_patches_reference)
    assert aux["win"].shape == (p["cam"].shape[0], WSZ, WSZ)


def test_search_window_is_the_region_cut(pairs):
    """The (15,15) window the search emits is the decoded region's cut at
    the best offset, as subpix_refine_region cut it before."""
    (tj, _), _ = _templates(pairs)
    P, G2 = 3, 2 * RANGE + 1 + 8 + 6
    hw = p_level_hw(H, W, "cpu")
    found, pos, _, aux = search_patches_reference(
        t(pairs["packed"]), hw, _i64(pairs["cam"]), _i64(pairs["level"]), t(np.asarray(tj)),
        t(pairs["uv"]), RANGE, t(np.float32(10.0)), exhaustive=t(pairs["fixed"]))
    lvl_f = t(pairs["level"]).float()
    pos_lev = (t(pairs["uv"]) + 0.5) / torch.exp2(lvl_f)[:, None] - 0.5
    c = torch.round(pos_lev).long()
    raw, ok = pbp.gather_windows3(t(pairs["packed"]), _i64(pairs["cam"]),
                                  _i64(pairs["level"]), c[:, 1] - RANGE - 4 - P,
                                  c[:, 0] - RANGE - 4 - P, G2)
    region2 = raw - PACK_CORNER * (raw >= PACK_CORNER / 2).float()
    by, bx = n(aux["by"]), n(aux["bx"])
    want = np.stack([n(region2)[k, y:y + WSZ, x:x + WSZ] for k, (y, x) in enumerate(zip(by, bx))])
    np.testing.assert_array_equal(n(aux["win"]), want)
    np.testing.assert_array_equal(n(aux["region_ok"]), n(ok))
    assert n(found).sum() > K // 4


@pytest.mark.parametrize("dtype,Kw,G", [
    (np.float32, 1000, 35), (np.float32, 60, 31), (np.uint8, 1000, 26), (np.uint8, 4096, 26),
])
def test_gather_windows_reference_unchanged(rng, dtype, Kw, G):
    """The window gather's plain version at the four cases chip_smoke.py
    holds the redesigned kernel to: a clamped copy, converted to f32."""
    plane = (rng.random((C * H, 700)) * 255).astype(dtype)
    rows = rng.integers(-8, plane.shape[0] - G + 8, Kw)
    cols = rng.integers(-8, plane.shape[1] - G + 8, Kw)
    got = n(gather_windows_reference(t(plane), t(rows), t(cols), G))
    r0 = np.clip(rows, 0, plane.shape[0] - G)
    c0 = np.clip(cols, 0, plane.shape[1] - G)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(
        got, np.stack([plane[r:r + G, c:c + G] for r, c in zip(r0, c0)]).astype(np.float32))
