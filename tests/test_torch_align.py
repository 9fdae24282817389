"""Port parity of map alignment (map/align.py): the dominant plane, the
plane-aligning transform, and the global transform and scale of a map,
against the JAX package on the same seeded inputs.

The JAX package draws its RANSAC triples with jax.random, the port with a
torch.Generator; the parity tests hand the port the JAX triples
(``dominant_plane_from_triples``) and hold everything after them to JAX.
Tolerances: inlier mask and ``ok`` exact; centre, normal (up to its sign),
transforms and map leaves 1e-5 (float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcptam_tpu.core.se3 import SE3 as JSE3, so3_exp
from mcptam_tpu.map import align as jalign
from mcptam_tpu.map.state import create_map_state
from mcptam_tpu_torch import convert
from mcptam_tpu_torch.core.se3 import SE3
from mcptam_tpu_torch.map import align as palign
from mcptam_tpu_torch.map.state import kf_cam_from_world

TOL = 1e-5
N_HYP = 128


def jax_triples(valid, key, n_hyp=N_HYP):
    """The triples mcptam_tpu/map/align.py::dominant_plane draws."""
    valid = jnp.asarray(valid)
    N = valid.shape[0]

    def triple(k):
        g = jax.random.gumbel(k, (N,)) + jnp.where(valid, 0.0, -1e9)
        return jax.lax.top_k(g, 3)[1]

    return np.array(jax.vmap(triple)(jax.random.split(key, n_hyp)))


def planar_cloud(rng, n_plane=80, n_out=20, N=128, n_shell=0, spread=1.0):
    """tests/test_align.py's tilted plane with outliers, padded to N slots
    (N = the valid count: no padding), plus n_shell points 0.2 off the
    plane, inliers only under a threshold above 0.2; ``spread`` scales the
    plane's extent."""
    n = np.array([0.2, -0.3, 0.93])
    n /= np.linalg.norm(n)
    c = np.array([0.5, -0.2, 2.0])
    u = np.cross(n, [1.0, 0, 0])
    u /= np.linalg.norm(u)
    v = np.cross(n, u)
    a = rng.normal(size=(n_plane + n_shell, 2)) * spread
    on = c + a[:, :1] * u + a[:, 1:] * v + rng.normal(size=(n_plane + n_shell, 3)) * 0.002
    on[n_plane:] += 0.2 * n
    k = n_plane + n_shell + n_out
    pts = np.zeros((N, 3), np.float32)
    pts[:n_plane + n_shell] = on
    pts[n_plane + n_shell:k] = c + rng.normal(size=(n_out, 3)) * 2.0
    valid = np.zeros(N, bool)
    valid[:k] = True
    return pts, valid, n, c


CLOUDS = {
    # padded: the median is NaN, the threshold 0.1
    "padded": dict(n_plane=80, n_out=20, N=128, n_shell=10, spread=3.0),
    # every slot valid, an even count: the median averages the middle two
    # (spread ~3.5, a threshold ~0.35)
    "all_valid_even": dict(n_plane=70, n_out=20, N=100, n_shell=10, spread=3.0),
    "all_valid_odd": dict(n_plane=70, n_out=21, N=101, n_shell=10, spread=3.0),
    # too few valid points: ok false
    "sparse": dict(n_plane=6, n_out=1, N=64),
}


@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_dominant_plane_matches_jax(rng, cloud):
    pts, valid, _, _ = planar_cloud(rng, **CLOUDS[cloud])
    key = jax.random.PRNGKey(7)
    jc, jn, jinl, jok = jalign.dominant_plane(jnp.asarray(pts), jnp.asarray(valid), key)
    pc, pn, pinl, pok = palign.dominant_plane_from_triples(
        torch.as_tensor(pts), torch.as_tensor(valid), torch.as_tensor(jax_triples(valid, key)))
    assert bool(pok) == bool(jok)
    np.testing.assert_array_equal(pinl.numpy(), np.asarray(jinl))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=0, atol=TOL)
    sign = np.sign(float(pn.numpy() @ np.asarray(jn)))
    np.testing.assert_allclose(sign * pn.numpy(), np.asarray(jn), rtol=0, atol=TOL)


@pytest.mark.parametrize("cloud", ["padded", "all_valid_even", "all_valid_odd"])
def test_median_branches(rng, cloud):
    """The threshold is 0.1 with any slot invalid (the reference's median
    is NaN there), else 10% of the median spread, the middle two averaged
    for an even count."""
    pts, valid, _, _ = planar_cloud(rng, **CLOUDS[cloud])
    tol = float(palign.inlier_threshold(torch.as_tensor(pts), torch.as_tensor(valid)))
    if not valid.all():
        assert tol == pytest.approx(0.1, rel=1e-7)
        return
    centroid = pts.sum(0) / len(pts)
    spread = np.sort(np.linalg.norm(pts - centroid, axis=-1))
    k = len(spread) // 2
    med = spread[k] if len(spread) % 2 else 0.5 * (spread[k - 1] + spread[k])
    assert tol == pytest.approx(0.1 * med, rel=1e-5)
    assert tol > 0.2          # the shell 0.2 off the plane lies within it


def test_port_triples_and_plane(rng):
    pts, valid, n_true, c_true = planar_cloud(rng)
    gen = torch.Generator().manual_seed(0)
    idx = palign.draw_triples(torch.as_tensor(valid), gen)
    assert idx.shape == (N_HYP, 3)
    assert bool(torch.as_tensor(valid)[idx].all())
    assert all(len(set(row)) == 3 for row in idx.tolist())
    c, n, inlier, ok = palign.dominant_plane(torch.as_tensor(pts), torch.as_tensor(valid),
                                             torch.Generator().manual_seed(0))
    assert bool(ok)
    assert abs(abs(float(n.numpy() @ n_true)) - 1.0) < 1e-3
    assert abs((c.numpy() - c_true) @ n_true) < 0.01
    assert int(inlier.sum()) > 60
    # the same seed draws the same triples
    again = palign.draw_triples(torch.as_tensor(valid), torch.Generator().manual_seed(0))
    assert torch.equal(idx, again)


@pytest.mark.parametrize("cloud,hint", [("padded", None), ("all_valid_even", (0.0, 0.3, 1.0)),
                                        ("sparse", None)])
def test_plane_align_transform_matches_jax(rng, cloud, hint):
    pts, valid, _, _ = planar_cloud(rng, **CLOUDS[cloud])
    key = jax.random.PRNGKey(1)
    jhint = None if hint is None else jnp.asarray(hint, jnp.float32)
    phint = None if hint is None else torch.tensor(hint)
    jT, jok = jalign.plane_align_transform(jnp.asarray(pts), jnp.asarray(valid), key, jhint)
    c, n, _, ok = palign.dominant_plane_from_triples(
        torch.as_tensor(pts), torch.as_tensor(valid), torch.as_tensor(jax_triples(valid, key)))
    pT = palign.plane_align_from_plane(c, n, ok, phint)
    assert bool(ok) == bool(jok)
    np.testing.assert_allclose(pT.R.numpy(), np.asarray(jT.R), rtol=0, atol=TOL)
    np.testing.assert_allclose(pT.t.numpy(), np.asarray(jT.t), rtol=0, atol=TOL)


def test_plane_align_puts_plane_at_z0(rng):
    pts, valid, _, _ = planar_cloud(rng)
    T, ok = palign.plane_align_transform(torch.as_tensor(pts), torch.as_tensor(valid),
                                         torch.Generator().manual_seed(1))
    assert bool(ok)
    moved = T.apply(torch.as_tensor(pts)).numpy()[valid]
    assert np.median(np.abs(moved[:80, 2])) < 0.01


def _map(rng, C=2, M=4, N=64):
    """tests/test_align.py's random map (the JAX MapState), with source
    keyframes and pixel rays so that the footprint refresh has work."""
    cfb = JSE3(R=jnp.stack([so3_exp(jnp.asarray([0.0, 0.1 * i, 0.0])) for i in range(C)]),
               t=jnp.asarray(rng.normal(size=(C, 3)) * 0.1, jnp.float32))
    ms = create_map_state(32, 32, C, cfb, N, M, 128)

    def ray(shift):
        r = rng.normal(size=(N, 3)) * 0.2 + np.array([0.0, 0.0, 1.0]) + shift
        return jnp.asarray(r / np.linalg.norm(r, axis=-1, keepdims=True), jnp.float32)

    pts = ms.points.replace(
        pos_w=jnp.asarray(rng.normal(size=(N, 3)) + np.array([0, 0, 3.0]), jnp.float32),
        valid=jnp.ones(N, bool),
        src_mkf=jnp.asarray(rng.integers(0, M, N), jnp.int32),
        src_cam=jnp.asarray(rng.integers(0, C, N), jnp.int32),
        center_nc=ray(0.0), right_nc=ray(np.array([0.01, 0, 0])),
        down_nc=ray(np.array([0, 0.01, 0])),
        pixel_right_w=jnp.asarray(rng.normal(size=(N, 3)) * 0.01, jnp.float32),
        pixel_down_w=jnp.asarray(rng.normal(size=(N, 3)) * 0.01, jnp.float32))
    mkfs = ms.mkfs.replace(
        base_from_world=JSE3(
            R=jnp.stack([so3_exp(jnp.asarray(rng.normal(size=3) * 0.1, jnp.float32))
                         for _ in range(M)]),
            t=jnp.asarray(rng.normal(size=(M, 3)), jnp.float32)),
        valid=jnp.ones(M, bool),
        scene_depth_mean=jnp.asarray(rng.uniform(1, 4, (M, C)), jnp.float32),
        scene_depth_sigma=jnp.asarray(rng.uniform(0.1, 1, (M, C)), jnp.float32))
    ms = ms.replace(points=pts, mkfs=mkfs)
    return ms, convert.map_state_from_numpy(jax.device_get(ms), device="cpu")


def _assert_maps_close(pms, jms):
    p, j = convert.to_numpy(pms), jax.device_get(jms)
    for group, names in (("points", ("pos_w", "pixel_right_w", "pixel_down_w")),
                         ("mkfs", ("scene_depth_mean", "scene_depth_sigma"))):
        for name in names:
            np.testing.assert_allclose(p[group][name], getattr(getattr(j, group), name),
                                       rtol=0, atol=TOL, err_msg=f"{group}.{name}")
    for f in ("R", "t"):
        np.testing.assert_allclose(p["mkfs"]["base_from_world"][f],
                                   getattr(j.mkfs.base_from_world, f), rtol=0, atol=TOL)


def test_apply_global_transform_matches_jax(rng):
    jms, pms = _map(rng)
    v = np.array([0.3, -0.2, 0.5, 0.1, 0.2, -0.15], np.float32)
    before = convert.to_numpy(pms)
    out = palign.apply_global_transform(pms, SE3.exp(torch.as_tensor(v)))
    _assert_maps_close(out, jalign.apply_global_transform(jms, JSE3.exp(jnp.asarray(v))))
    # the input map is left as it was
    np.testing.assert_array_equal(pms.points.pos_w.numpy(), before["points"]["pos_w"])
    np.testing.assert_array_equal(pms.points.pixel_right_w.numpy(),
                                  before["points"]["pixel_right_w"])


def test_global_transform_preserves_reprojection(rng):
    _, pms = _map(rng)
    T = SE3.exp(torch.tensor([0.3, -0.2, 0.5, 0.1, 0.2, -0.15]))
    out = palign.apply_global_transform(pms, T)
    a, b = kf_cam_from_world(pms), kf_cam_from_world(out)
    pa = torch.einsum("mcij,nj->mcni", a.R, pms.points.pos_w) + a.t[:, :, None]
    pb = torch.einsum("mcij,nj->mcni", b.R, out.points.pos_w) + b.t[:, :, None]
    torch.testing.assert_close(pa, pb, rtol=0, atol=1e-4)


def test_apply_global_scale_matches_jax(rng):
    jms, pms = _map(rng)
    _assert_maps_close(palign.apply_global_scale(pms, 2.5),
                       jalign.apply_global_scale(jms, 2.5))
