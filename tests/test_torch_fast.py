"""Port parity of the FAST front-end (the plain version of csrc/fast.cu),
the adaptive thresholds, candidate cutoffs and candidate lists, and the
whole feature front-end; and an emulation of csrc/fast.cu's arithmetic
and tiling (doubling arc minima, the two-compare histogram bin, 30x30
output tiles scored from staged 38x40 windows), held to the JAX package.

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
from mcptam_tpu_torch.ops.fast import BORDER, RING_OFFSETS
from mcptam_tpu_torch.ops.fast_kernel import (
    NBINS, fast_frontend, fast_frontend_levels, fast_frontend_reference,
)
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


def test_frontend_row_range_on_a_slab(rng):
    """The histograms over a row range (K1's form for a row shard of a
    sharded image, parallel/mesh.py): on a slab of rows with a 4-row halo
    each side, the slab's scores and nonmax match the JAX kernel's in
    interpret mode on the slab, and its interior rows match the JAX
    kernel's on the whole image; the histograms count exactly those
    interior rows, as a cumulative count of the JAX scores there gives."""
    img = _image(rng, (2, 64, 96))
    s0, s1, a, b = 12, 44, 4, 28          # slab rows, its interior rows
    slab = img[:, s0:s1]
    score, nm, freq, freq_nm = fast_frontend_reference(t(slab), rows=(a, b))
    j_slab = j_kernel(jnp.asarray(slab), interpret=True)
    j_whole = j_kernel(jnp.asarray(img), interpret=True)
    _equal(score, j_slab[0])
    _equal(nm, j_slab[1])
    _equal(score[:, a:b], np.asarray(j_whole[0])[:, s0 + a:s0 + b])
    _equal(nm[:, a:b], np.asarray(j_whole[1])[:, s0 + a:s0 + b])

    def cumfreq(x):
        flat = np.asarray(x).reshape(x.shape[0], -1)
        return np.stack([(flat > np.float32(th) - np.float32(1e-6)).sum(-1)
                         for th in range(NBINS)], -1).astype(np.float32)

    _equal(freq, cumfreq(np.asarray(j_slab[0])[:, a:b]))
    _equal(freq_nm, cumfreq(np.asarray(j_slab[1])[:, a:b]))
    # the whole slab by default, and through the one-launch entry point
    _equal(fast_frontend_reference(t(slab))[2], j_slab[2])
    got = fast_frontend_levels([t(slab)], rows=[(a, b)])[0]
    for g, r in zip(got, (score, nm, freq, freq_nm)):
        _equal(g, r)
    with pytest.raises(ValueError, match="histogram rows"):
        fast_frontend_levels([t(slab)], rows=[(a, s1 - s0 + 1)])


def test_frontend_levels_match_jax_on_pyramid():
    """The one-launch entry point on the CPU: every level of the rendered
    frame's pyramid equals the JAX reference, and nothing is launched."""
    frames = jax_scene()[-1]
    pyr = build_pyramid(t(frames[0].astype(np.float32)))
    launches = backend.kernel_report()["fast_frontend"]
    got = fast_frontend_levels([p.contiguous() for p in pyr])
    assert backend.kernel_report()["fast_frontend"] == launches
    assert len(got) == len(pyr)
    for lvl, g in zip(pyr, got):
        for a, b in zip(g, jax.jit(j_reference)(jnp.asarray(n(lvl)))):
            _equal(a, b)


# ---- csrc/fast.cu, emulated: its arithmetic and its tiles ----------------

OUT_TILE, SCORE_TILE, STAGE_W, STAGE_H = 30, 32, 40, 38


def _kernel_score(r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fast_score() of csrc/fast.cu on ring values r (...,16) and centres
    c: runs of 2 and 4 by doubling, the 10-arc as min(run 8, run 2),
    bright arcs folded with max from arc 0, dark arcs as maxima folded with
    min, all on the ring values; c subtracted from the two results."""
    def roll(x, k):
        return torch.roll(x, -k, -1)
    lo2, hi2 = torch.minimum(r, roll(r, 1)), torch.maximum(r, roll(r, 1))
    lo4, hi4 = torch.minimum(lo2, roll(lo2, 2)), torch.maximum(hi2, roll(hi2, 2))
    arc_lo = torch.minimum(torch.minimum(lo4, roll(lo4, 4)), roll(lo2, 8))
    arc_hi = torch.maximum(torch.maximum(hi4, roll(hi4, 4)), roll(hi2, 8))
    bright, dark = arc_lo[..., 0], arc_hi[..., 0]
    for i in range(1, 16):
        bright = torch.maximum(bright, arc_lo[..., i])
        dark = torch.minimum(dark, arc_hi[..., i])
    return torch.clamp(torch.maximum(bright - c, c - dark), min=0.0)


def _threshold(tt: torch.Tensor) -> torch.Tensor:
    return tt.to(torch.float32) - 1e-6          # f32, as float(t) - 1e-6f


def _kernel_bin(s: torch.Tensor) -> torch.Tensor:
    """bin_of() of csrc/fast.cu: floor(s) plus two compares, 64 above."""
    f = torch.clamp(s, max=float(NBINS)).to(torch.int64)
    b = f + (s > _threshold(f)).long() + ((f + 1 < NBINS) & (s > _threshold(f + 1))).long()
    return torch.where(s < NBINS, b, torch.full_like(b, NBINS))


def _loop_bin(s: torch.Tensor) -> torch.Tensor:
    """The 64-compare definition: thresholds s passes."""
    ts = _threshold(torch.arange(NBINS))
    return (s[..., None] > ts).sum(-1)


def _kernel_frontend(img: torch.Tensor):
    """csrc/fast.cu's blocks, one (camera, tile) at a time: stage the 38x40
    window (zero outside the image, left edge on a multiple of 4), score
    the 32x32 tile, take the nonmax of its inner 30x30, bin the outputs."""
    C, H, W = img.shape
    score, nm = torch.zeros_like(img), torch.zeros_like(img)
    counts = torch.zeros((2, C, NBINS + 1), dtype=torch.int64)
    sy = torch.arange(SCORE_TILE)[:, None]
    lane = torch.arange(SCORE_TILE)[None, :]
    for c in range(C):
        for y0 in range(0, H, OUT_TILE):
            for x0 in range(0, W, OUT_TILE):
                xs, ys = (x0 - 4) & ~3, y0 - 4
                assert xs % 4 == 0 and x0 - 1 - xs in (3, 5)
                tile = torch.zeros((STAGE_H, STAGE_W))
                gy, gx = ys + torch.arange(STAGE_H), xs + torch.arange(STAGE_W)
                vy, vx = (gy >= 0) & (gy < H), (gx >= 0) & (gx < W)
                tile[vy[:, None] & vx[None, :]] = img[c][gy[vy]][:, gx[vx]].reshape(-1)
                cy, cx = sy + BORDER, lane + (x0 - 1 - xs)
                # indexing raises if a ring pixel falls outside the window
                ring = torch.stack([tile[cy + dy, cx + dx] for dy, dx in RING_OFFSETS], -1)
                s = _kernel_score(ring, tile[cy, cx])
                y, x = y0 - 1 + sy, x0 - 1 + lane
                s = torch.where((x >= BORDER) & (x < W - BORDER) & (y >= BORDER)
                                & (y < H - BORDER), s, torch.zeros_like(s))
                ctr = s[1:-1, 1:-1]
                keep = torch.ones_like(ctr, dtype=torch.bool)
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        if dy or dx:
                            nb = s[1 + dy:SCORE_TILE - 1 + dy, 1 + dx:SCORE_TILE - 1 + dx]
                            keep &= ctr > nb if (dy < 0 or (dy == 0 and dx < 0)) else ctr >= nb
                nmv = torch.where(keep, ctr, torch.zeros_like(ctr))
                hh, ww = min(OUT_TILE, H - y0), min(OUT_TILE, W - x0)
                score[c, y0:y0 + hh, x0:x0 + ww] = ctr[:hh, :ww]
                nm[c, y0:y0 + hh, x0:x0 + ww] = nmv[:hh, :ww]
                for which, v in enumerate((ctr[:hh, :ww], nmv[:hh, :ww])):
                    counts[which, c] += torch.bincount(_kernel_bin(v).reshape(-1),
                                                       minlength=NBINS + 1)
    # freq[t] = number of pixels whose bin exceeds t (the last block's sums)
    freq = torch.flip(torch.cumsum(torch.flip(counts[..., 1:], (-1,)), -1), (-1,))
    return score, nm, freq[0].to(torch.float32), freq[1].to(torch.float32)


def _jax_score(img):
    return np.asarray(jax.jit(jfast.fast_score_image)(jnp.asarray(img)))


@pytest.mark.parametrize("shape,kind", [((2, 48, 64), "integers"), ((1, 61, 83), "integers"),
                                        ((3, 30, 40), "integers"), ((2, 40, 52), "floats")])
def test_kernel_score_arithmetic_matches_jax(rng, shape, kind):
    """The kernel's score arithmetic (arcs on the ring values, the centre
    subtracted after) on a whole random image, bit-equal to
    mcptam_tpu/ops/fast.py's scores: integer images, and floats of any
    fraction, where only the monotone rounding of r - c makes it exact."""
    img = _image(rng, shape) if kind == "integers" else (rng.random(shape) * 255).astype(np.float32)
    x = t(img)
    ring = torch.stack([pfast._shift2d(x, dy, dx) for dy, dx in RING_OFFSETS], -1)
    s = _kernel_score(ring, x)
    ys = torch.arange(shape[1])[:, None]
    xs = torch.arange(shape[2])[None, :]
    inb = (ys >= BORDER) & (ys < shape[1] - BORDER) & (xs >= BORDER) & (xs < shape[2] - BORDER)
    _equal(torch.where(inb, s, torch.zeros_like(s)), _jax_score(img))


@pytest.mark.parametrize("source", ["rendered pyramid", "random integers"])
def test_kernel_tiles_match_jax_frontend(rng, source):
    """The kernel's tiles, staging and bins on every level of the rendered
    frame's pyramid (dyadic values) and on random integer images whose
    widths are not multiples of 4: all four outputs equal the JAX
    reference, and the scores equal mcptam_tpu/ops/fast.py's."""
    if source == "rendered pyramid":
        imgs = [n(p) for p in build_pyramid(t(jax_scene()[-1][1].astype(np.float32)))]
    else:
        imgs = [_image(rng, (2, 67, 95)), _image(rng, (1, 31, 33))]
    for img in imgs:
        got = _kernel_frontend(t(img))
        for g, r in zip(got, jax.jit(j_reference)(jnp.asarray(img))):
            _equal(g, r)
        _equal(got[0], _jax_score(img))


def test_kernel_bin_equals_the_64_compare_loop():
    """bin_of()'s two compares equal the 64-compare loop on every score
    a dyadic level can produce (multiples of 2^-6 in [0, 255]), on the
    floats within 1e-6 of every integer, and on random scores."""
    ks = np.arange(256, dtype=np.float64)
    vals = [np.arange(255 * 64 + 1, dtype=np.float64) / 64.0,
            ks + 1e-6, ks - 1e-6,
            np.float32(ks) + np.float32(1e-6), np.float32(ks) - np.float32(1e-6),
            np.nextafter(np.float32(ks), np.float32(np.inf)),
            np.nextafter(np.float32(ks), np.float32(-np.inf)),
            np.random.default_rng(5).random(20000) * 300.0]
    s = torch.as_tensor(np.clip(np.concatenate(vals), 0.0, None).astype(np.float32))
    _equal(_kernel_bin(s), _loop_bin(s))
