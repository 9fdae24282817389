"""The port's client/server split on the CPU: MapServer against the JAX
package's on the same messages, a port client/server loop over loopback
TCP at tests/test_distributed.py's size, and the two apps.

Map-state parity: one INIT payload (the JAX package's features of the
mapping scene's first keyframe, as ``feats_to_arrays`` gives them) and one
ADD (the second keyframe with a synthetic tracker result) go through both
packages' ``MapServer.handle_message`` and ``spin_once``; the JAX builder's
scatter fault is repaired in this process (ROADMAP section C), as in
tests/test_torch_mapmaker.py.  The UPDATE sections are compared: every
integer and flag exact; triangulated points and their pixel footprints all
within 2% of their norm and 97% within 2e-3 (the midpoint triangulation
cancels digits in f32 for near-parallel rays, tests/test_torch_mapmaker.py);
the rest of the float state within 1e-3.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    C, H, MKF_TANGENTS, W, jax_builder_drops_unplaced, jax_scene, mapping_scene, np_get,
    synthetic_track_result,
)

from mcptam_tpu.config import MapMakerConfig as JMC
from mcptam_tpu.map.state import create_map_state as j_create
from mcptam_tpu.system import network as jnet
from mcptam_tpu_torch import convert
from mcptam_tpu_torch.apps import client as client_app, server as server_app
from mcptam_tpu_torch.config import MapMakerConfig, TrackerConfig
from mcptam_tpu_torch.core.se3 import SE3
from mcptam_tpu_torch.io.synthetic import make_rig, make_sbi_cams, render_rig
from mcptam_tpu_torch.map.state import SRC_TRACKER, create_map_state
from mcptam_tpu_torch.system import network as pnet
from mcptam_tpu_torch.system.client import SystemClient
from mcptam_tpu_torch.system.netcodec import (
    ACTION_ADD, ACTION_INIT, ACTION_UPDATE, unpack_arrays,
)
from chip_smoke import recording_sends, settle, wait_for_ba
from tests.test_apps import _rig_json, _video_npz

POINT_GEOMETRY = ("pt_pos_w", "pt_pixel_right_w", "pt_pixel_down_w")
CAPS = dict(max_points=384, max_mkfs=4, max_meas=2048)


def _cmp_update(p: dict, j: dict):
    assert list(p) == list(j)
    for k, val in p.items():
        ref = np.asarray(j[k])
        assert val.dtype == ref.dtype and val.shape == ref.shape, k
        if val.dtype.kind != "f":
            np.testing.assert_array_equal(val, ref, err_msg=k)
        elif k in POINT_GEOMETRY:
            d = np.abs(val - ref).max(-1)
            scale = np.maximum(np.abs(ref).max(-1), 1e-6)
            assert (d <= 0.02 * scale + 1e-6).all(), (k, (d / scale).max())
            assert (d <= 2e-3 * np.maximum(scale, 1.0)).mean() >= 0.97, k
        else:
            np.testing.assert_allclose(val, ref, rtol=1e-3, atol=1e-3, err_msg=k)


def test_map_server_matches_jax():
    """INIT, then an ADD carrying tracker measurements, through both
    servers: the same UPDATE sections after each, and the tracker's
    measurements recorded on the port's server."""
    jcams, jcfb, _, _, _ = jax_scene()
    _, _, _, feats = mapping_scene()
    pcams = convert.camera_from_numpy(np_get(jcams), device="cpu")
    pcfb = convert.se3_from_numpy(np_get(jcfb), device="cpu")
    mcfg = dict(init_depth=5.0)
    jch, pch = jnet.Channel.serve(0), pnet.Channel.serve(0)
    try:
        jserver = jnet.MapServer(jch, jcams, j_create(H, W, C, jcfb, *CAPS.values()),
                                 mcfg=JMC(**mcfg))
        pserver = pnet.MapServer(pch, pcams, create_map_state(H, W, C, pcfb, *CAPS.values()),
                                 mcfg=MapMakerConfig(**mcfg))
        with jax_builder_drops_unplaced():
            def both(action, d):
                jserver.handle_message(action, d)
                pserver.handle_message(action, d)

            def kf(k):
                return {key: np.asarray(a) for key, a in jnet.feats_to_arrays(
                    jax.tree_util.tree_map(jnp.asarray, feats[k]),
                    jnet.SE3.exp(jnp.asarray(MKF_TANGENTS[k]))).items()}

            both(ACTION_INIT, kf(0))
            _cmp_update(pnet.map_update_arrays(pserver.ms), jnet.map_update_arrays(jserver.ms))
            n_init = int(pserver.ms.points.valid.sum())
            assert n_init > 50

            add = kf(1)
            add.update(synthetic_track_result(convert.to_numpy(pserver.ms), pcams,
                                              MKF_TANGENTS[1]))
            add["cam_active"] = np.ones(C, bool)
            both(ACTION_ADD, add)
            assert jserver.spin_once(timeout_ms=0) and pserver.spin_once(timeout_ms=0)
        assert pserver.mapmaker.last_timing.kind == jserver.mapmaker.last_timing.kind \
            == "creation"
        pu, ju = pnet.map_update_arrays(pserver.ms), jnet.map_update_arrays(jserver.ms)
        _cmp_update(pu, ju)
        assert pu["mkf_valid"].sum() == 2 and pu["pt_valid"].sum() > n_init
        tracker = pu["ms_valid"] & (pu["ms_source"] == SRC_TRACKER)
        assert tracker.sum() > 30
        assert pserver.ms.points.pos_w.device.type == "cpu"
    finally:
        jch.close()
        pch.close()


def test_no_update_before_init():
    """ROADMAP section C: the JAX server ticks its map-maker before any
    INIT, and the global BA of its empty map finishes and sends an UPDATE,
    which a client that connects later takes for the answer to its INIT
    (the init then fails, and the retried INIT lands in another MKF slot
    on the server).  The port's server stays quiet until its INIT and then
    answers it."""
    jcams, jcfb, _, _, _ = jax_scene()
    _, _, _, feats = mapping_scene()
    pcams = convert.camera_from_numpy(np_get(jcams), device="cpu")
    pcfb = convert.se3_from_numpy(np_get(jcfb), device="cpu")
    first = {}
    for name, pkg, server_of in (
            ("jax", jnet, lambda ch: jnet.MapServer(
                ch, jcams, j_create(H, W, C, jcfb, *CAPS.values()))),
            ("port", pnet, lambda ch: pnet.MapServer(
                ch, pcams, create_map_state(H, W, C, pcfb, *CAPS.values())))):
        sch = pkg.Channel.serve(0)
        cch = pkg.Channel.connect("127.0.0.1", sch.port)
        try:
            server = server_of(sch)
            deadline = time.time() + 60.0
            for _ in range(20):
                server.spin_once(timeout_ms=0)
            while name == "jax" and time.time() < deadline and sch.stats["msgs_sent"] == 0:
                server.spin_once(timeout_ms=0)
            first[name] = cch.poll(timeout_ms=500)
            if name == "port":
                cch.send(ACTION_INIT, pnet.feats_to_arrays(
                    convert.frame_features_from_numpy(feats[0], device="cpu"),
                    SE3.exp(torch.as_tensor(MKF_TANGENTS[0]))))
                assert server.spin_once(timeout_ms=5000) and server.initialised
                action, d = cch.poll(timeout_ms=5000)
                assert action == ACTION_UPDATE and d["mkf_valid"][0] and d["pt_valid"].sum() > 50
        finally:
            cch.close()
            sch.close()
    action, d = first["jax"]
    assert action == ACTION_UPDATE and not d["mkf_valid"].any()
    assert first["port"] is None


# ---------------------------------------------------------------------------
# a port client/server loop (tests/test_distributed.py::test_client_server_loop)
# ---------------------------------------------------------------------------

LOOP_CAPS = dict(max_points=2048, max_mkfs=8, max_meas=8192)


def test_client_server_loop():
    cams, cfb = make_rig(C, H, W, spread_deg=25.0, device="cpu")
    cams_sbi = make_sbi_cams(cams, H, W)
    mcfg = MapMakerConfig(init_depth=5.0, max_scaled_mkf_dist=0.04)
    tcfg = TrackerConfig(max_patches_per_frame=200, coarse_max=20, coarse_min=6)
    server_ch = pnet.Channel.serve(0)
    server_sent = recording_sends(server_ch)
    server = pnet.MapServer(server_ch, cams, create_map_state(H, W, C, cfb, **LOOP_CAPS),
                            mcfg=mcfg)
    stop = threading.Event()
    th = threading.Thread(target=server.run, args=(stop,), daemon=True)
    th.start()
    sysc = SystemClient(cams, cfb, cams_sbi, H, W, "127.0.0.1", server_ch.port, tcfg, mcfg,
                        **LOOP_CAPS)
    client_sent = recording_sends(sysc.channel)
    try:
        last = None
        for i in range(7):
            p = SE3.exp(torch.tensor([0.05 * i, 0.0, 0.03 * i, 0.0, 0.02 * i, 0.0]))
            img = torch.clamp(render_rig(cams, cfb, p, 3.0, H, W), 0, 255).to(torch.uint8)
            info = sysc.process_frame(img)
            terr = float(np.linalg.norm(info.pose[:, 3] - p.t.numpy()))
            assert not info.lost, f"lost at frame {i}"
            assert terr < 0.06, (i, terr)
            last = info
        assert last.n_mkfs >= 3, last.n_mkfs
        stats = sysc.channel.stats
        assert stats["msgs_sent"] >= 3          # INIT + ADDs
        assert stats["msgs_recv"] >= 2          # UPDATEs + STATEs
        # JPEG imagery keeps an ADD well under the ~300 KB lossless atlas
        assert stats["bytes_sent"] < stats["msgs_sent"] * 220_000, stats
        sysc.flush_pipeline()
        # the server integrates what is queued and finishes a BA, then the
        # two sides exchange their last messages in turn (chip_smoke phase 9)
        wait_for_ba(server, sysc, client_sent, 180.0)
    finally:
        stop.set()
        th.join(timeout=120.0)
    try:
        assert not th.is_alive()
        settle(server, server_sent, sysc, client_sent, 120.0)
    finally:
        sysc.close()
        server_ch.close()
    ms = server.ms
    assert int(ms.mkfs.valid.sum()) >= 2
    # the client's tracker measurements crossed the wire and were recorded
    # at integration
    assert int((ms.meas.valid & (ms.meas.source == SRC_TRACKER)).sum()) > 0
    assert int(ms.points.valid.sum()) > 100
    assert server.monitor_count >= 1
    mon = server.client_monitor
    assert mon["small_image"].ndim == 3 and mon["pose"].shape == (3, 4)
    # after the final exchange the client holds the map sections of the
    # server's last UPDATE
    final = unpack_arrays([blob for action, blob in server_sent if action == ACTION_UPDATE][-1])
    mine = pnet.map_update_arrays(sysc.ms)
    for k, v in final.items():
        if k.startswith(("pt_", "ms_")):
            np.testing.assert_array_equal(mine[k], v, err_msg=k)


# ---------------------------------------------------------------------------
# the apps
# ---------------------------------------------------------------------------

CLI_CAPS = ["--max-points", "1024", "--max-mkfs", "8", "--max-meas", "4096"]


def test_server_and_client_apps(tmp_path, capsys):
    """The server app as a process on the CPU (the PORT handshake, a clean
    SIGTERM exit), the client app against it in this process: every frame
    reported, none lost."""
    rig, jcams, jcfb = _rig_json(tmp_path)
    video, _ = _video_npz(tmp_path, jcams, jcfb)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="2")
    server = subprocess.Popen(
        [sys.executable, "-m", "mcptam_tpu_torch.apps.server", "--rig", rig, "--port", "0",
         "--device", "cpu", *CLI_CAPS],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=root)
    try:
        line = server.stdout.readline()
        assert line.startswith("PORT "), (line, server.stderr.read() if server.poll() else "")
        port = int(line.split()[1])
        system, infos = client_app.run(client_app.parse_args(
            ["--rig", rig, "--video", video, "--server", f"127.0.0.1:{port}", "--fps", "1000",
             "--device", "cpu", *CLI_CAPS]))
        out = capsys.readouterr().out
        assert [i.frame_id for i in infos] == list(range(5))
        assert not any(i.lost for i in infos)
        assert [ln.split()[1] for ln in out.splitlines() if ln.startswith("frame ")] \
            == [str(i) for i in range(5)]
        assert "lost=1" not in out
        assert system.device.type == "cpu"
        with pytest.raises(RuntimeError, match="closed"):   # run() closed it
            system.channel.stats
    finally:
        server.send_signal(signal.SIGTERM)
        rc = server.wait(timeout=60)
    assert rc == 0, server.stderr.read()[-2000:]


@pytest.mark.parametrize("app", [server_app, client_app], ids=["server", "client"])
def test_apps_default_to_cuda(tmp_path, app):
    """Without --device the apps run on the GPU; on a machine without CUDA
    they raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    rig, jcams, jcfb = _rig_json(tmp_path)
    argv = ["--rig", rig]
    if app is client_app:
        video, _ = _video_npz(tmp_path, jcams, jcfb, n_frames=1)
        argv += ["--video", video, "--server", "127.0.0.1:1"]
    assert app.parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(argv)
