"""Port parity of the `mcptam` app: python -m mcptam_tpu_torch.apps.mcptam
(``--device cpu``) against the JAX package's app on tests/test_apps.py's
5-frame, 2-camera, 240x320 sequence, as a .npz and as a PGM dataset
directory, both replayed through the native frame queue.

Both apps run in this process with their default configurations; the JAX
builder's scatter fault (ROADMAP section C) is repaired in this process,
as in tests/test_torch_live.py.  Tolerances: per-frame found, points,
MKFs and lost flags exact; poses 1e-4 (tests/test_torch_live.py's bar);
the eval scores 1e-4."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from _torch_parity import jax_builder_drops_unplaced

import mcptam_tpu.apps.mcptam as japp
from mcptam_tpu_torch.apps import mcptam as papp
from mcptam_tpu_torch.io.dataset import export_sequence_dir
from tests.test_apps import _rig_json, _video_npz

POSE_TOL = 1e-4
EVAL_TOL = 1e-4


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("app")
    rig, cams, cfb = _rig_json(d)
    video, traj = _video_npz(d, cams, cfb)
    gt = str(d / "gt.npy")
    np.save(gt, np.stack([np.asarray(p.ln()) for p in traj]))
    dataset = str(d / "dataset")
    with open(rig) as f:
        rig_doc = json.load(f)
    with np.load(video) as z:
        export_sequence_dir(dataset, z["frames"], rig_doc=rig_doc)
    return {"rig": rig, "npz": video, "dataset": dataset, "gt": gt, "dir": d}


def _argv(inputs, source):
    video = ["--video", inputs[source]]
    rig = ["--rig", inputs["rig"]] if source == "npz" else []
    return [*rig, *video, "--fps", "1000", "--eval-gt", inputs["gt"]]


def _eval(out: str) -> dict:
    line = [ln for ln in out.splitlines() if ln.startswith("[mcptam] eval ")][0]
    return json.loads(line[len("[mcptam] eval "):])


def _run_jax(argv):
    """The JAX app's main, its FrameInfos caught on the way out of its
    tracking loop."""
    caught = {}
    loop = japp.run_tracking_loop

    def catching(*a, **k):
        caught["infos"] = loop(*a, **k)
        return caught["infos"]

    japp.run_tracking_loop = catching
    out = io.StringIO()
    try:
        with jax_builder_drops_unplaced(), contextlib.redirect_stdout(out):
            assert japp.main(argv) == 0
    finally:
        japp.run_tracking_loop = loop
    return caught["infos"], out.getvalue()


def _run_port(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        system, infos = papp.run(papp.parse_args(["--device", "cpu", *argv]))
    return system, infos, out.getvalue()


@pytest.fixture(scope="module")
def runs(inputs):
    res = {}
    for source in ("npz", "dataset"):
        argv = _argv(inputs, source)
        out_map = str(inputs["dir"] / f"port_{source}.npz")
        res[source] = (_run_jax(argv), _run_port([*argv, "--out-map", out_map]), out_map)
    return res


@pytest.mark.parametrize("source", ["npz", "dataset"])
def test_app_matches_jax(runs, source):
    (jinfos, jout), (_, pinfos, pout), _ = runs[source]
    assert [i.frame_id for i in pinfos] == [i.frame_id for i in jinfos] == list(range(5))
    for pi, ji in zip(pinfos, jinfos):
        for name in ("n_found", "n_points", "n_mkfs", "lost"):
            assert getattr(pi, name) == getattr(ji, name), (ji.frame_id, name)
        np.testing.assert_allclose(pi.pose, ji.pose, rtol=0, atol=POSE_TOL)
    je, pe = _eval(jout), _eval(pout)
    assert pe["lost_frames"] == je["lost_frames"]
    for group in ("ate", "rpe"):
        for key, val in je[group].items():
            assert abs(pe[group][key] - val) <= EVAL_TOL, (group, key, pe[group][key], val)


@pytest.mark.parametrize("source", ["npz", "dataset"])
def test_app_gates(runs, source):
    """tests/test_apps.py::test_mcptam_app's gates on the port's app."""
    _, (system, _, out), out_map = runs[source]
    assert "frame    4" in out and "lost=0" in out
    assert os.path.exists(out_map)
    scores = _eval(out)
    assert scores["lost_frames"] == 0
    assert scores["ate"]["rmse"] < 0.05, scores
    assert system.device.type == "cpu"


def test_app_defaults_to_cuda(inputs):
    """Without --device the app runs on the GPU; on a machine without CUDA
    it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    args = papp.parse_args(["--rig", inputs["rig"], "--video", inputs["npz"]])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        papp.run(args)
