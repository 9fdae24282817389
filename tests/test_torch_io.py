"""Port parity of the I/O layer and run scoring: rig JSON (io/rig_config),
dataset directories (io/dataset), the native synchronised frame queue and
its replay source (io/video_source, native/), ground-truth loading, and
rpe / evaluate_run (system/evaluate), each against the JAX package on the
same seeded inputs.

Tolerances: camera parameters and extrinsics 1e-6 (float32 from the same
float64 host fit); images, timestamps, masks, names and queue output
exact; scores 1e-9 (float64 host numpy in both).  Two tests show the
port's intended divergences (ROADMAP section C): big-endian 16-bit PGM
samples, and a replay that holds every frame."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import mcptam_tpu.io.video_source as jvs
import mcptam_tpu_torch.io.video_source as pvs
from mcptam_tpu.apps._common import load_gt_poses as j_load_gt_poses
from mcptam_tpu.io import dataset as jds, rig_config as jrig
from mcptam_tpu.system import evaluate as jev
from mcptam_tpu_torch import convert
from mcptam_tpu_torch.apps._common import load_gt_poses
from mcptam_tpu_torch.io import dataset as pds, rig_config as prig
from mcptam_tpu_torch.system import evaluate as pev

PARAM_TOL = 1e-6
SCORE_TOL = 1e-9
H, W = 48, 64
PARAMS = [[90.0, -1e-3, 2e-6, -5e-9, 33.0, 25.0, 1.0, 0.0, 0.0],
          [85.0, -2e-3, 1e-6, 0.0, 31.0, 22.0, 1.01, 0.002, -0.001]]


def _rig_doc(tmp_path, rng, scale=1.0, masks=True):
    os.makedirs(tmp_path / "masks", exist_ok=True)
    cams = []
    for c, params in enumerate(PARAMS):
        entry = {"name": f"cam_{c}", "params": params,
                 "cam_from_base": [float(x) for x in rng.normal(size=6) * 0.2]}
        if masks:
            m = rng.random((H, W)) > 0.2
            np.save(tmp_path / "masks" / f"camera{c}.npy", m)
            entry["mask"] = f"masks/camera{c}.npy"
        cams.append(entry)
    doc = {"width": W, "height": H, "cameras": cams, "extrinsic_scale": scale}
    path = str(tmp_path / "rig.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path, doc


def _assert_rigs_match(port, jax_):
    pcams, pcfb, ph, pw, pmasks, pnames = port
    jcams, jcfb, jh, jw, jmasks, jnames = jax_
    assert (ph, pw, pnames) == (jh, jw, jnames)
    if jmasks is None:
        assert pmasks is None
    else:
        assert pmasks.dtype == np.bool_
        np.testing.assert_array_equal(pmasks, jmasks)
    pc, jc = convert.to_numpy(pcams), jcams
    for name, val in pc.items():
        np.testing.assert_allclose(val, np.asarray(getattr(jc, name)), rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=name)
    np.testing.assert_allclose(pcfb.R.numpy(), np.asarray(jcfb.R), rtol=0, atol=PARAM_TOL)
    np.testing.assert_allclose(pcfb.t.numpy(), np.asarray(jcfb.t), rtol=0, atol=PARAM_TOL)


@pytest.mark.parametrize("scale,masks", [(1.0, False), (1.7, True)])
def test_load_rig_matches_jax(tmp_path, rng, scale, masks):
    path, _ = _rig_doc(tmp_path, rng, scale, masks)
    _assert_rigs_match(prig.load_rig(path, device="cpu"), jrig.load_rig(path))


def test_save_rig_roundtrip(tmp_path, rng):
    path, doc = _rig_doc(tmp_path, rng, scale=1.0)
    cams, cfb, h, w, masks, names = prig.load_rig(path, device="cpu")
    out = str(tmp_path / "saved.json")
    prig.save_rig(out, PARAMS, (w, h), cam_from_base=cfb, names=names,
                  masks_rel=[c["mask"] for c in doc["cameras"]])
    _assert_rigs_match(prig.load_rig(out, device="cpu"), jrig.load_rig(path))
    # the JAX writer's document reads back the same through the port
    jcams, jcfb, *_ = jrig.load_rig(path)
    jout = str(tmp_path / "jsaved.json")
    jrig.save_rig(jout, PARAMS, (w, h), cam_from_base=jcfb, names=names,
                  masks_rel=[c["mask"] for c in doc["cameras"]])
    _assert_rigs_match(prig.load_rig(jout, device="cpu"), jrig.load_rig(out))


def test_load_video_and_gt_poses(tmp_path, rng):
    frames = rng.integers(0, 255, (2, 3, H, W), dtype=np.uint8)
    np.savez(tmp_path / "v.npz", frames=frames)
    np.save(tmp_path / "v.npy", frames)
    for name in ("v.npz", "v.npy"):
        p = str(tmp_path / name)
        np.testing.assert_array_equal(prig.load_video(p), jrig.load_video(p))
    ln = rng.normal(size=(6, 6)).astype(np.float32) * 0.3
    np.save(tmp_path / "gt6.npy", ln)
    np.testing.assert_allclose(load_gt_poses(str(tmp_path / "gt6.npy")),
                               j_load_gt_poses(str(tmp_path / "gt6.npy")), rtol=0, atol=1e-6)
    gt34 = rng.normal(size=(4, 3, 4))
    np.save(tmp_path / "gt34.npy", gt34)
    np.testing.assert_array_equal(load_gt_poses(str(tmp_path / "gt34.npy")), gt34)


# -- dataset directories (tests/test_dataset.py's cases) ----------------------

def _frames(rng, C=2, T=5, h=24, w=32):
    return rng.integers(0, 255, size=(C, T, h, w), dtype=np.uint8)


def _export_pgm(path, rng):
    fr = _frames(rng)
    pds.export_sequence_dir(path, fr, fmt="pgm")
    return fr


def _export_png(path, rng):
    pytest.importorskip("PIL")
    fr = _frames(rng)
    pds.export_sequence_dir(path, fr, fmt="png")
    return fr


def _export_stamped(path, rng):
    fr = _frames(rng, T=6)
    ts = np.stack([np.linspace(100.0, 101.0, 6), np.linspace(100.001, 101.001, 6)])
    pds.export_sequence_dir(path, fr, timestamps=ts)
    return fr


def _export_uneven(path, rng):
    fr = _frames(rng)
    pds.export_sequence_dir(path, fr)
    os.remove(os.path.join(path, "camera2", "000004.pgm"))
    return fr


@pytest.mark.parametrize("export,limit,T", [
    (_export_pgm, 0, 5), (_export_png, 0, 5), (_export_stamped, 4, 4), (_export_uneven, 0, 4),
])
def test_sequence_dir_matches_jax(tmp_path, rng, export, limit, T):
    fr = export(str(tmp_path), rng)
    frames, ts = pds.load_sequence_dir(str(tmp_path), limit=limit)
    jframes, jts = jds.load_sequence_dir(str(tmp_path), limit=limit)
    assert frames.shape[1] == T
    np.testing.assert_array_equal(frames, fr[:, :T])
    np.testing.assert_array_equal(frames, jframes)
    np.testing.assert_array_equal(ts, jts)
    assert np.all(np.diff(ts, axis=1) > 0)


def test_export_matches_jax(tmp_path, rng):
    """The port's exporter writes the JAX exporter's files byte for byte."""
    fr = _frames(rng)
    ts = np.stack([np.arange(5) / 7.0, np.arange(5) / 7.0 + 1e-4])
    pds.export_sequence_dir(str(tmp_path / "p"), fr, timestamps=ts, rig_doc={"a": 1})
    jds.export_sequence_dir(str(tmp_path / "j"), fr, timestamps=ts, rig_doc={"a": 1})
    for root, _, files in os.walk(tmp_path / "j"):
        for f in files:
            j = os.path.join(root, f)
            p = j.replace(str(tmp_path / "j"), str(tmp_path / "p"))
            assert open(p, "rb").read() == open(j, "rb").read(), f


def test_load_dataset_matches_jax(tmp_path, rng):
    fr = _frames(rng, C=2, h=H, w=W)
    _, doc = _rig_doc(tmp_path / "rigsrc", rng, masks=False)
    pds.export_sequence_dir(str(tmp_path / "ds"), fr, names=["cam_0", "cam_1"], rig_doc=doc)
    port = pds.load_dataset(str(tmp_path / "ds"), device="cpu")
    jax_ = jds.load_dataset(str(tmp_path / "ds"))
    _assert_rigs_match(port[:6], jax_[:6])
    np.testing.assert_array_equal(port[6], fr)
    np.testing.assert_array_equal(port[6], jax_[6])
    np.testing.assert_array_equal(port[7], jax_[7])
    with pytest.raises(FileNotFoundError):      # a directory without rig.json
        pds.load_dataset(str(tmp_path / "rigsrc" / "masks"), device="cpu")


def _pgm16(path, samples: np.ndarray):
    h, w = samples.shape
    with open(path, "wb") as f:
        f.write(b"P5\n# 16-bit\n%d %d\n65535\n" % (w, h))
        f.write(samples.astype(">u2").tobytes())


def test_pgm_16bit_is_big_endian(tmp_path, rng):
    """Intended divergence: P5 stores 16-bit samples most significant byte
    first.  The port decodes them so; the reference reads them in the
    host's byte order, which on a little-endian host swaps the bytes."""
    samples = rng.integers(0, 65536, size=(6, 10)).astype(np.uint16)
    path = str(tmp_path / "x.pgm")
    _pgm16(path, samples)
    expect = (samples.astype(np.float32) * (255.0 / 65535)).astype(np.uint8)
    np.testing.assert_array_equal(pds.load_image(path), expect)
    swapped = samples.byteswap() if np.little_endian else samples
    np.testing.assert_array_equal(
        jds.load_image(path), (swapped.astype(np.float32) * (255.0 / 65535)).astype(np.uint8))
    # the 8-bit path is the same in both
    p8 = str(tmp_path / "y.pgm")
    img8 = rng.integers(0, 255, (6, 10), dtype=np.uint8)
    with open(p8, "wb") as f:
        f.write(b"P5\n10 6\n255\n" + img8.tobytes())
    np.testing.assert_array_equal(pds.load_image(p8), img8)
    np.testing.assert_array_equal(pds.load_image(p8), jds.load_image(p8))


def test_pgm_rejects_malformed(tmp_path):
    for name, data in (("a.pgm", b"P2\n2 2\n255\n0 0 0 0"), ("b.pgm", b"P5\n4 4"),
                       ("c.pgm", b"P5\n4 4\n255\n" + bytes(7))):
        with open(tmp_path / name, "wb") as f:
            f.write(data)
        with pytest.raises(ValueError):
            pds.load_image(str(tmp_path / name))


# -- the native frame queue (tests/test_native.py's cases) --------------------

def _queue_sync(mod, rng):
    q = mod.SyncedFrameQueue(2, 8, 8, sync_tol=0.01)
    f0 = rng.integers(0, 255, (8, 8), dtype=np.uint8)
    f1 = rng.integers(0, 255, (8, 8), dtype=np.uint8)
    trace = []
    q.push(0, 1.000, f0)
    q.push(1, 1.004, f1)                      # within tolerance
    trace.append(q.get(timeout_ms=500))
    q.push(0, 2.0, f0)                        # unmatched: nothing released
    trace.append(q.get(timeout_ms=50))
    q.push(1, 2.5, f1)                        # too far: old head dropped
    q.push(0, 2.498, f0)
    trace.append(q.get(timeout_ms=500))
    trace.append(q.dropped)
    q.close()
    assert trace[0] is not None and np.array_equal(trace[0][0][0], f0)
    assert np.array_equal(trace[0][0][1], f1) and trace[1] is None
    assert abs(trace[2][1][0] - 2.498) < 1e-9
    return trace


def _queue_dynamic(mod, rng):
    q = mod.SyncedFrameQueue(2, 8, 8, sync_tol=0.05)
    f = rng.integers(0, 255, (8, 8), dtype=np.uint8)
    q.set_dynamic_sync(True)
    trace = [q.effective_sync_tol]            # no rate observed yet: static
    for i in range(6):                        # both cameras at 100 frames/s
        q.push(0, 1.0 + 0.01 * i, f)
        q.push(1, 1.0 + 0.01 * i + 0.001, f)
        trace.append(q.get(timeout_ms=200))
    trace.append(q.effective_sync_tol)
    q.push(0, 2.0, f)                         # 8 ms apart: no longer a pair
    q.push(1, 2.008, f)
    trace.append(q.get(timeout_ms=50))
    q.set_dynamic_sync(False)
    trace.append(q.effective_sync_tol)
    q.push(0, 3.0, f)
    q.push(1, 3.008, f)
    trace.append(q.get(timeout_ms=200))
    q.close()
    assert abs(trace[0] - 0.05) < 1e-12 and trace[7] <= 0.5 * 0.0105 + 1e-6
    assert trace[8] is None and abs(trace[9] - 0.05) < 1e-12 and trace[10] is not None
    return trace


def _replay(mod, rng):
    frames = rng.integers(0, 255, (2, 5, 8, 8), dtype=np.uint8)
    src = mod.ReplaySource(frames, fps=1000.0)
    src.start()
    got = [src.queue.get(timeout_ms=1000) for _ in range(5)]
    src.join()
    src.queue.close()
    assert all(g is not None for g in got)
    for t_, (imgs, _) in enumerate(got):
        np.testing.assert_array_equal(imgs, frames[:, t_])
    # the jitter's draws interleave with the producer threads: stamps differ run to run
    return [imgs for imgs, _ in got]


def _same(a, b):
    if isinstance(a, tuple) or isinstance(a, list):
        assert len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b
    return True


@pytest.mark.parametrize("case", [_queue_sync, _queue_dynamic, _replay])
def test_frame_queue_matches_jax(case):
    port = case(pvs, np.random.default_rng(42))
    jax_ = case(jvs, np.random.default_rng(42))
    _same(port, jax_)


def test_replay_through_queue_with_stamps(rng):
    fr = _frames(rng, T=4)
    ts = np.stack([np.arange(4) / 10.0, np.arange(4) / 10.0 + 1e-4])
    src = pvs.ReplaySource(fr, timestamps=ts)
    src.start()
    got = [src.queue.get(timeout_ms=2000) for _ in range(4)]
    src.join()
    src.queue.close()
    np.testing.assert_array_equal(got[0][0], fr[:, 0])
    np.testing.assert_allclose(got[2][1], ts[:, 2], atol=1e-9)


def test_replay_holds_every_frame(rng):
    """Intended divergence: a replay whose producers finish before the
    tracker reads keeps every frame in the port; the reference's queue
    keeps the newest 8 a camera and drops the rest."""
    frames = rng.integers(0, 255, (2, 20, 8, 8), dtype=np.uint8)
    got = {}
    for name, mod in (("port", pvs), ("jax", jvs)):
        src = mod.ReplaySource(frames, fps=30.0, jitter=0.0)
        src.start()
        src.join()
        sets = []
        while (out := src.queue.get(timeout_ms=100)) is not None:
            sets.append(out[0])
        got[name] = (sets, src.queue.dropped)
        src.queue.close()
    sets, dropped = got["port"]
    assert len(sets) == 20 and dropped == 0
    for t_, imgs in enumerate(sets):
        np.testing.assert_array_equal(imgs, frames[:, t_])
    jsets, jdropped = got["jax"]
    assert len(jsets) == 8 and jdropped == 2 * 12
    np.testing.assert_array_equal(jsets[0], frames[:, 12])


def test_queue_rejects_a_wrong_frame():
    q = pvs.SyncedFrameQueue(2, 8, 8)
    with pytest.raises(ValueError):
        q.push(0, 0.0, np.zeros((8, 9), np.uint8))
    with pytest.raises(ValueError):
        q.push(2, 0.0, np.zeros((8, 8), np.uint8))
    q.close()


# -- run scoring ----------------------------------------------------------------

def _trajectory(rng, T=12):
    from mcptam_tpu_torch.core.se3 import SE3
    v = np.cumsum(rng.normal(0, 0.05, (T, 6)), 0)
    v[:, 3:] *= 0.3
    p = SE3.exp(torch.as_tensor(v, dtype=torch.float32))
    return np.concatenate([p.R.numpy(), p.t.numpy()[..., None]], -1).astype(np.float64)


@pytest.mark.parametrize("delta", [1, 3])
def test_rpe_matches_jax(rng, delta):
    gt = _trajectory(rng)
    est = gt + rng.normal(0, 0.01, gt.shape)
    for a, b in ((est, gt), (gt, gt)):
        p, j = pev.rpe(a, b, delta), jev.rpe(a, b, delta)
        assert p.keys() == j.keys()
        for k in j:
            assert abs(p[k] - j[k]) <= SCORE_TOL, (k, p[k], j[k])


def test_evaluate_run_matches_jax(rng):
    gt = _trajectory(rng)
    est = gt + rng.normal(0, 0.01, gt.shape)
    infos = [SimpleNamespace(pose=est[i].astype(np.float32), lost=bool(i in (3, 7)))
             for i in range(len(gt))]
    p, j = pev.evaluate_run(infos, gt, delta=2), jev.evaluate_run(infos, gt, delta=2)
    assert p["lost_frames"] == j["lost_frames"] == 2
    for group in ("ate", "rpe"):
        assert p[group].keys() == j[group].keys()
        for k in j[group]:
            assert abs(p[group][k] - j[group][k]) <= SCORE_TOL, (group, k)
    with pytest.raises(ValueError):
        pev.evaluate_run(infos[:-1], gt)
    with pytest.raises(ValueError):
        pev.rpe(gt[:2], gt[:2], delta=2)
