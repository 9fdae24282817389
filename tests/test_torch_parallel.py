"""Port parity of parallel/mesh.py: the sharded functions at worlds 2 and
4 (gloo ranks spawned by tests/_torch_mesh_worker.py) against the JAX
package's sharded functions on conftest's 8-device CPU mesh and against
the port's unsharded functions, and at world 1 in this process.

The world is tests/test_parallel.py's (H, W, C = 64, 96, 2; 256 points,
8 MKFs, 1024 measurements), its map built by the port and carried into
the JAX MapState (tests/_torch_parity.py says why).

BA also runs a noisy problem (ba/problems.build: 4 poses, 64 points, 512
measurements) for 3 steps, which every run accepts, with its observation
table (the point axis sharded) and without it (the measurement axis
sharded): the world's map is noiseless, so its LM accepts nothing and its
cost (~3e-9 px^2) is float32 rounding of 1024 residuals.  Past a few steps a float32 LM's accept path
departs under any change in the order of its sums (the ranks' partial
sums are one), so the step counts are chosen where the paths agree.

Tolerances: against JAX, tests/test_parallel.py's own (cost rtol 1e-4;
poses rtol 1e-4, atol 1e-5; points rtol 1e-3, atol 1e-4; atlas and SBI
rtol 1e-5, atol 1e-3; epipolar positions rtol 1e-4, atol 1e-4 / 1e-3),
the noiseless problem's cost with an absolute floor of 1e-6 px^2;
integers exact.  Against the unsharded port: the tracker, the epipolar
search and the frame features gather and never add across ranks, so they
are exact; BA sums over the ranks, so its floats take the same
tolerances as against JAX and its counts are exact.  At world 1 every
function is exact.  Each world's ranks are spawned once for the module
(about 4 s for four ranks here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_tree_from_numpy, n, np_get
import _torch_mesh_worker as worker

from mcptam_tpu.ba.adjusters import problem_all as j_problem_all
from mcptam_tpu.ba.bundle import BundleProblem as JBundleProblem
from mcptam_tpu.ba.bundle import attach_obs_table as j_attach, max_obs_per_point as j_max_obs
from mcptam_tpu.config import TrackerConfig as JTrackerConfig
from mcptam_tpu.core.se3 import SE3 as JSE3
from mcptam_tpu.io.synthetic import make_rig as j_make_rig, make_sbi_cams as j_sbi_cams
from mcptam_tpu.io.synthetic import render_rig as j_render_rig
from mcptam_tpu.map.state import create_map_state as j_create_map_state
from mcptam_tpu.parallel import mesh as jmesh
from mcptam_tpu.tracker.tracker import create_tracker_state as j_tracker_state
from mcptam_tpu_torch import convert
from mcptam_tpu_torch.ba.adjusters import problem_all
from mcptam_tpu_torch.ba.bundle import (
    attach_obs_table, create_lm_state, lm_run, max_obs_per_point,
)
from mcptam_tpu_torch.ba.problems import build
from mcptam_tpu_torch.config import TrackerConfig
from mcptam_tpu_torch.io.synthetic import build_groundtruth_map
from mcptam_tpu_torch.map.epipolar import epipolar_match
from mcptam_tpu_torch.map.keyframe import make_frame_features
from mcptam_tpu_torch.map.state import clone_tree
from mcptam_tpu_torch.parallel import mesh as M
from mcptam_tpu_torch.tracker.tracker import apply_tracker_point_stats, track_frame

H, W, C = 64, 96, 2
Q = 24            # epipolar candidates: divisible by 8, 4 and 2
STEPS = {"lm": 2, "lm_soa": 3, "noisy": 3, "noisy_lm": 3}
TCFG_KW = dict(max_patches_per_frame=64, coarse_max=8, coarse_min=4,
               coarse_range=8, fine_range_first=6, fine_range=4)
TCFG = TrackerConfig(**TCFG_KW)
POSE = dict(rtol=1e-4, atol=1e-5)
PTS = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def world():
    """The same inputs for both packages: JAX objects, the port's, and the
    numpy inputs of the spawned ranks."""
    cams, cfb = j_make_rig(C, H, W, spread_deg=25.0)
    cams_sbi = j_sbi_cams(cams, H, W)
    p_cams = convert.camera_from_numpy(np_get(cams), device="cpu")
    p_cfb = convert.se3_from_numpy(np_get(cfb), device="cpu")
    p_ms, _ = build_groundtruth_map(p_cams, p_cfb, H, W, n_per_level=24,
                                    max_points=256, max_mkfs=8, max_meas=1024)
    ms = jax_tree_from_numpy(j_create_map_state(H, W, C, cfb, 256, 8, 1024),
                             convert.to_numpy(p_ms))
    images = np.asarray(j_render_rig(
        cams, cfb, JSE3.exp(jnp.asarray([0.02, -0.01, 0.015, 0.004, -0.006, 0.003])),
        3.0, H, W), np.float32)
    feats = make_frame_features(torch.as_tensor(images.copy()))
    epi = (np.zeros(Q, np.int32), np.zeros(Q, np.int32), np.zeros(Q, np.int32),
           np.ones(Q, np.int32), np.zeros(Q, np.int32),
           n(feats.cand_xy[0][0][:Q]).astype(np.float32), n(feats.cand_valid[0][0][:Q]))
    prob = problem_all(p_ms)
    prob_t = attach_obs_table(prob, int(max_obs_per_point(prob)))
    noisy_nt, noisy_cams = build(n_poses=4, n_points=64, n_cams=2,
                                 noise=0.5, device="cpu")
    noisy = attach_obs_table(noisy_nt, int(max_obs_per_point(noisy_nt)))
    ts = convert.tracker_state_from_numpy(np_get(j_tracker_state(C)), device="cpu")
    # static masks: a band of rows at the top, and a block across the
    # middle rows (the boundary of every world's row shards)
    masks = np.ones((C, H, W), bool)
    masks[:, :6] = False
    masks[0, 24:40, 30:70] = False
    masks[1, 28:36, 10:50] = False
    inputs = dict(
        cams=convert.to_numpy(p_cams), cams_sbi=np_get(cams_sbi),
        ms=convert.to_numpy(p_ms), images=images, prob=convert.to_numpy(prob),
        prob_t=convert.to_numpy(prob_t), noisy=convert.to_numpy(noisy),
        noisy_nt=convert.to_numpy(noisy_nt),
        noisy_cams=convert.to_numpy(noisy_cams), epi=epi, ts=convert.to_numpy(ts),
        masks=masks,
        tcfg=TCFG, steps=STEPS)
    return dict(cams=cams, cfb=cfb, cams_sbi=cams_sbi, ms=ms, images=images,
                epi=epi, inputs=inputs)


def _jax_problem(src: dict, D: int | None = None):
    """The port's problem (numpy dict) as the JAX package's, with an
    observation table of D slots a point, or none for D None."""
    kw = {k: jnp.asarray(v) for k, v in src.items()
          if isinstance(v, np.ndarray) and not k.startswith("obs")}
    for k in ("pose_a", "pose_b"):
        kw[k] = JSE3(R=jnp.asarray(src[k]["R"]), t=jnp.asarray(src[k]["t"]))
    prob = JBundleProblem(**kw)
    return prob if D is None else j_attach(prob, D)


@pytest.fixture(scope="module")
def port(world):
    """The port's unsharded results on the same inputs."""
    p = worker.port_inputs(world["inputs"])
    feats = make_frame_features(p["images"])
    out = {"feats": convert.to_numpy(feats),
           "feats_masked": convert.to_numpy(make_frame_features(p["images"],
                                                                p["masks"]))}
    st = lm_run(p["prob"], create_lm_state(p["prob"]), p["cams"], STEPS["lm"])
    out["lm"] = convert.to_numpy(st)
    st = lm_run(p["noisy_nt"], create_lm_state(p["noisy_nt"]), p["noisy_cams"],
                STEPS["noisy_lm"])
    out["noisy_lm"] = convert.to_numpy(st)
    for key, prob, cams in (("lm_soa", p["prob_t"], p["cams"]),
                            ("noisy", p["noisy"], p["noisy_cams"])):
        st = lm_run(prob, create_lm_state(prob), cams, STEPS[key], fixed_b=True)
        out[key] = convert.to_numpy(st)
    ts, res = track_frame(p["ts"], p["ms"], p["cams"], p["cams_sbi"], feats, TCFG)
    out["track"] = (convert.to_numpy(ts), convert.to_numpy(res))
    ms = clone_tree(p["ms"])
    apply_tracker_point_stats(ms, res, min_outliers=0)
    out["stats"] = {k: n(getattr(ms.points, k)) for k in ("in_count", "out_count", "bad")}
    out["epi"] = convert.to_numpy(epipolar_match(p["ms"], p["cams"], *p["epi"]))
    return out


@pytest.fixture(scope="module")
def jax_ref(world):
    """The JAX package's sharded functions on the 8-device mesh."""
    mesh = jmesh.make_mesh(8)
    cams, ms = world["cams"], world["ms"]
    out = {}
    fn, img = jmesh.sharded_frame_features(mesh, jnp.asarray(world["images"]))
    out["feats"] = np_get(fn(img))
    prob = j_problem_all(ms)
    out["lm"] = np_get(jmesh.sharded_lm_run(mesh, prob, cams, n_steps=STEPS["lm"])[0])
    prob_t = j_attach(prob, int(j_max_obs(prob)))
    out["lm_soa"] = np_get(jmesh.sharded_lm_run_soa(mesh, prob_t, cams,
                                                    n_steps=STEPS["lm_soa"])[0])
    src = world["inputs"]["noisy"]
    noisy_cams = jax_tree_from_numpy(j_make_rig(2)[0], world["inputs"]["noisy_cams"])
    out["noisy"] = np_get(jmesh.sharded_lm_run_soa(
        mesh, _jax_problem(src, src["obs_idx"].shape[1]), noisy_cams,
        n_steps=STEPS["noisy"])[0])
    out["noisy_lm"] = np_get(jmesh.sharded_lm_run(
        mesh, _jax_problem(world["inputs"]["noisy_nt"]), noisy_cams,
        n_steps=STEPS["noisy_lm"])[0])
    fn, ms_sh = jmesh.sharded_track_frame(mesh, ms, cams, world["cams_sbi"],
                                          JTrackerConfig(**TCFG_KW))
    feats = jax.tree_util.tree_map(jnp.asarray, out["feats"])
    out["track"] = np_get(fn(j_tracker_state(C), ms_sh, feats))
    out["epi"] = np_get(jmesh.sharded_epipolar_match(mesh)(
        ms, cams, *(jnp.asarray(a) for a in world["epi"])))
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, world, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"mesh{request.param}")
    return worker.spawn(request.param, world["inputs"], str(root))


def _equal(a, b, name=""):
    """Nested numpy dicts / tuples, exactly."""
    if isinstance(a, dict):
        for k in a:
            _equal(a[k], b[k], f"{name}.{k}")
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{name}[{i}]")
    elif a is not None:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


# ---- every rank, every function ------------------------------------------

def test_every_rank_gets_the_same_result(ranks):
    """Replicated results: each rank's output equals rank 0's, the Schur
    matrices of every LM step included (each rank solves the same system)."""
    for r, out in enumerate(ranks):
        assert out["rank"] == r and out["world"] == len(ranks)
        for key in ("feats", "feats_masked", "lm", "lm_soa", "noisy", "noisy_lm",
                    "schur", "track", "stats", "epi"):
            _equal(out[key], ranks[0][key], f"rank {r} {key}")


def test_sizes_that_do_not_divide_raise(ranks):
    """A size that does not divide by the ranks raises a ValueError naming
    it (L, K, Q and the image rows by 8 x the ranks); none is padded."""
    assert set(ranks[0]["bad"]) == {"points L", "measurements K", "candidates Q",
                                    "image rows H"}
    for what, msg in ranks[0]["bad"].items():
        assert msg is not None and what in msg and "does not divide" in msg, (what, msg)


def test_make_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.make_mesh()


# ---- frame features: the image rows sharded -------------------------------

INT_FEATS = ("corner_atlas", "thresholds", "corner_counts", "cand_xy", "cand_score",
             "cand_valid")


def test_sharded_frame_features(ranks, port, jax_ref):
    got = ranks[0]["feats"]
    _equal(got, port["feats"], "features vs the unsharded port")
    ref = jax_ref["feats"]
    for name in ("atlas", "sbi", "sbi_gx", "sbi_gy"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-3, err_msg=name)
    for name in INT_FEATS:
        _equal(got[name], getattr(ref, name), name)


def test_sharded_frame_features_with_static_masks(ranks, port):
    """Static masks, sliced to each rank's rows of every level, give the
    unsharded port's masked features exactly."""
    got = ranks[0]["feats_masked"]
    _equal(got, port["feats_masked"], "masked features vs the unsharded port")
    assert (got["corner_counts"] < port["feats"]["corner_counts"]).any()


# ---- BA --------------------------------------------------------------------

def _get(x, *path):
    """A field of a nested numpy dict (the port's) or struct (JAX's)."""
    for k in path:
        x = x[k] if isinstance(x, dict) else getattr(x, k)
    return np.asarray(x)


def _hold_lm(got, ref, points=True, cost_floor=0.0):
    np.testing.assert_allclose(got["cost"], _get(ref, "cost"), rtol=1e-4, atol=cost_floor)
    np.testing.assert_allclose(got["pose_a"]["t"], _get(ref, "pose_a", "t"), **POSE)
    if points:
        np.testing.assert_allclose(got["points"], _get(ref, "points"), **PTS)


def test_sharded_lm_run(ranks, port, jax_ref):
    """The measurement axis sharded (no observation table), on the
    noiseless world."""
    got = ranks[0]["lm"]
    _hold_lm(got, port["lm"], cost_floor=1e-6)
    assert int(got["accepted"]) == int(port["lm"]["accepted"])
    _hold_lm(got, jax_ref["lm"], points=False, cost_floor=1e-6)


def test_sharded_lm_run_noisy(ranks, port, jax_ref):
    """The measurement axis sharded on the noisy problem without its table,
    whose steps are all accepted: the reduced normal equations, median and
    costs move the poses and points as the unsharded port and the JAX
    package's sharded run move them."""
    got = ranks[0]["noisy_lm"]
    assert int(port["noisy_lm"]["accepted"]) == STEPS["noisy_lm"]
    for ref in (port["noisy_lm"], jax_ref["noisy_lm"]):
        for key in ("accepted", "iterations", "converged"):
            assert int(got[key]) == int(_get(ref, key)), key
        _hold_lm(got, ref)


def test_sharded_lm_run_soa(ranks, port, jax_ref):
    """The production layout, the point axis sharded."""
    got = ranks[0]["lm_soa"]
    for ref in (port["lm_soa"], jax_ref["lm_soa"]):
        assert int(got["accepted"]) == int(_get(ref, "accepted"))
        _hold_lm(got, ref, cost_floor=1e-6)


def test_sharded_lm_run_soa_noisy(ranks, port, jax_ref):
    """A noisy problem, whose steps are accepted, against the unsharded
    port and the JAX package's sharded run."""
    got = ranks[0]["noisy"]
    assert int(port["noisy"]["accepted"]) == STEPS["noisy"]
    for ref in (port["noisy"], jax_ref["noisy"]):
        for key in ("accepted", "iterations", "converged"):
            assert int(got[key]) == int(_get(ref, key)), key
        _hold_lm(got, ref)


# ---- tracking: the map's points sharded -------------------------------------

def test_sharded_track_frame(ranks, port, jax_ref):
    got_ts, got_res = ranks[0]["track"]
    _equal((got_ts, got_res), port["track"], "track vs the unsharded port")
    ref_ts, ref_res = jax_ref["track"]
    np.testing.assert_allclose(got_ts["pose"]["t"], np.asarray(ref_ts.pose.t), **POSE)
    assert int(got_res["tot_found"]) == int(ref_res.tot_found)


def test_point_stats_written_on_the_owner(ranks, port):
    _equal(ranks[0]["stats"], port["stats"], "point stats")
    assert ranks[0]["stats"]["in_count"].sum() > 0


# ---- the epipolar search: the candidate axis sharded -----------------------

def test_sharded_epipolar_match(ranks, port, jax_ref):
    got = ranks[0]["epi"]
    _equal(got, port["epi"], "epipolar vs the unsharded port")
    ref = [np.asarray(x) for x in jax_ref["epi"]]
    assert ref[0].sum() > 0
    np.testing.assert_array_equal(got[0], ref[0])
    ok = ref[0]
    np.testing.assert_allclose(got[1][ok], ref[1][ok], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[2][ok], ref[2][ok], rtol=1e-4, atol=1e-3)


# ---- world 1, in this process -----------------------------------------------

def test_world1_is_bit_identical(world, port):
    """A single-rank gloo group over a file store: every sharded function
    equals the unsharded one exactly, and the group is ended after."""
    p = worker.port_inputs(world["inputs"])
    mesh = M.make_mesh(device="cpu")
    try:
        assert (mesh.rank, mesh.world, mesh.device.type) == (0, 1, "cpu")
        fn, images = M.sharded_frame_features(mesh, p["images"])
        _equal(convert.to_numpy(fn(images)), port["feats"], "feats")
        for key, prob, cams in (("lm", p["prob"], p["cams"]),
                                ("noisy_lm", p["noisy_nt"], p["noisy_cams"])):
            st, _ = M.sharded_lm_run(mesh, prob, cams, STEPS[key])
            _equal(convert.to_numpy(st), port[key], key)
        for key, prob, cams in (("lm_soa", p["prob_t"], p["cams"]),
                                ("noisy", p["noisy"], p["noisy_cams"])):
            st, _ = M.sharded_lm_run_soa(mesh, prob, cams, STEPS[key])
            _equal(convert.to_numpy(st), port[key], key)
        fn, ms_local = M.sharded_track_frame(mesh, p["ms"], p["cams"], p["cams_sbi"], TCFG)
        feats = make_frame_features(p["images"])
        ts, res = fn(p["ts"], ms_local, feats)
        _equal((convert.to_numpy(ts), convert.to_numpy(res)), port["track"], "track")
        _equal(convert.to_numpy(M.sharded_epipolar_match(mesh)(p["ms"], p["cams"],
                                                               *p["epi"])),
               port["epi"], "epi")
    finally:
        mesh.close()
    assert not torch.distributed.is_initialized()
