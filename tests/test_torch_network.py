"""Port parity of the client/server wire: the array codec
(system/netcodec.py), the native net manager (native/netmanager.cc) behind
``Channel``, and the keyframe conversions of system/network.py, against the
JAX package.

A JAX process and a port process must read each other's messages, so the
codec's blobs are compared byte for byte and each side unpacks the other's;
the two channels talk to each other over loopback in both directions.  The
keyframe conversions are exact: every array ``feats_to_arrays`` gives, and
the atlas ``arrays_to_feats`` rebuilds from the level-0 image (the pyramid
of a uint8 image is exact in f32), are bit for bit the JAX package's.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import C, H, MKF_TANGENTS, W, jax_scene, mapping_scene, n, np_get

from mcptam_tpu.core.se3 import SE3 as JSE3
from mcptam_tpu.map.state import create_map_state as j_create
from mcptam_tpu.system import netcodec as jcodec, network as jnet
from mcptam_tpu.system.system import System as JSystem
from mcptam_tpu_torch import convert
from mcptam_tpu_torch.core.se3 import SE3
from mcptam_tpu_torch.map.state import create_map_state as p_create
from mcptam_tpu_torch.system import netcodec as pcodec, network as pnet
from mcptam_tpu_torch.system.system import System

SMALL = dict(max_points=64, max_mkfs=4, max_meas=256)


def _arrays(rng):
    """One array of every codec dtype, a 0-d scalar and (C,H,W) uint8
    image planes."""
    yy, xx = np.mgrid[0:64, 0:96]
    img = np.clip(96 + 60 * np.sin(xx / 7.0) * np.cos(yy / 9.0)
                  + rng.normal(0, 4, (64, 96)), 0, 255).astype(np.uint8)
    return {
        "u8": rng.integers(0, 255, (3, 5), dtype=np.uint8),
        "i32": np.arange(10, dtype=np.int32),
        "i64": np.asarray(7, np.int64),
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "f64": rng.normal(size=(2,)),
        "mask": rng.random(7) > 0.5,
        "u32": np.arange(4, dtype=np.uint32),
        "f16": np.ones(3, np.float16),          # outside the set: float32
        "img0": np.stack([img, img[::-1]]),
    }


def _assert_same(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("jpeg", [False, True])
@pytest.mark.parametrize("compress", [True, False])
def test_codec_blobs_identical(rng, jpeg, compress):
    """The same dict packs to the same bytes in both packages, and each
    side's unpack reads the other's blob exactly."""
    d = _arrays(rng)
    keys = ("img0",) if jpeg else ()
    jb = jcodec.pack_arrays(d, compress=compress, jpeg_keys=keys)
    pb = pcodec.pack_arrays(d, compress=compress, jpeg_keys=keys)
    assert pb == jb
    _assert_same(pcodec.unpack_arrays(jb), jcodec.unpack_arrays(jb))
    _assert_same(jcodec.unpack_arrays(pb), pcodec.unpack_arrays(pb))
    out = pcodec.unpack_arrays(pb)
    assert out["i64"].shape == (1,) and int(out["i64"].ravel()[0]) == 7
    assert out["f16"].dtype == np.float32
    want = "jpeg" if jpeg else "raw"
    assert pcodec.message_encodings(pb) == {k: want if k == "img0" else "raw" for k in d}
    if jpeg:
        err = np.abs(out["img0"].astype(np.float32) - d["img0"])
        assert float(err.mean()) < 3.0          # quality 90 is near-lossless
    else:
        np.testing.assert_array_equal(out["img0"], d["img0"])


def test_codec_without_pillow_ships_lossless(rng, monkeypatch):
    """The reference's soft Pillow rule (ROADMAP section C): without Pillow
    a key asked for as JPEG travels as lossless planes, in both packages
    alike, and the receiver reads it."""
    d = _arrays(rng)
    with_jpeg = pcodec.pack_arrays(d, jpeg_keys=("img0",))
    monkeypatch.setattr(jcodec, "_PILImage", None)
    monkeypatch.setattr(pcodec, "_PILImage", None)
    jb = jcodec.pack_arrays(d, jpeg_keys=("img0",))
    pb = pcodec.pack_arrays(d, jpeg_keys=("img0",))
    assert pb == jb == pcodec.pack_arrays(d)
    assert pcodec.message_encodings(pb)["img0"] == "raw"
    _assert_same(jcodec.unpack_arrays(pb), pcodec.unpack_arrays(pcodec.pack_arrays(d)))
    # a JPEG blob needs Pillow on the receiving side
    with pytest.raises(RuntimeError, match="Pillow"):
        pcodec.unpack_arrays(with_jpeg)


def _channels(server_pkg, client_pkg):
    server = server_pkg.Channel.serve(0)
    return server, client_pkg.Channel.connect("127.0.0.1", server.port)


def _poll(ch, timeout_s=10.0):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        out = ch.poll(timeout_ms=200)
        if out is not None:
            return out
    raise AssertionError("no message arrived")


@pytest.mark.parametrize("server_pkg,client_pkg", [(jnet, pnet), (pnet, jnet)],
                         ids=["jax_server-port_client", "port_server-jax_client"])
def test_channels_interoperate(rng, server_pkg, client_pkg):
    """A JAX channel and a port channel exchange messages both ways,
    above 1 MiB too, with the same accounting on both ends."""
    server, client = _channels(server_pkg, client_pkg)
    try:
        small = {"x": rng.normal(size=(100,)).astype(np.float32)}
        client.send(3, small)
        action, d = _poll(server)
        assert action == 3
        np.testing.assert_array_equal(d["x"], small["x"])
        big = {"img": rng.integers(0, 255, (4, 480, 1000), dtype=np.uint8)}
        server.send(5, big)                    # ~1.9 MB: past the poll buffer
        action, d = _poll(client)
        assert action == 5
        np.testing.assert_array_equal(d["img"], big["img"])
        cs, ss = client.stats, server.stats
        assert cs["msgs_sent"] == ss["msgs_recv"] == 1
        assert ss["msgs_sent"] == cs["msgs_recv"] == 1
        assert cs["bytes_sent"] == ss["bytes_recv"] > 0
        assert ss["bytes_sent"] == cs["bytes_recv"] > (1 << 20)
    finally:
        client.close()
        server.close()


@pytest.mark.parametrize("server_pkg,client_pkg", [(jnet, pnet), (pnet, jnet), (pnet, pnet)],
                         ids=["jax_server-port_client", "port_server-jax_client",
                              "port_both"])
def test_partition_recovery(server_pkg, client_pkg):
    """tests/test_native.py's partition case across the packages: after
    both ends break the link, queued messages arrive in order, none lost,
    through the automatic reconnect."""
    server, client = _channels(server_pkg, client_pkg)
    try:
        client.send(1, {"i": np.asarray([0], np.int32)})
        assert _poll(server) is not None
        client.break_connection()
        server.break_connection()
        for i in range(1, 4):
            client.send(1, {"i": np.asarray([i], np.int32)})
        got = []
        deadline = time.time() + 10.0
        while len(got) < 3 and time.time() < deadline:
            out = server.poll(timeout_ms=500)
            if out is not None:
                got.append(int(out[1]["i"][0]))
        assert got == [1, 2, 3], got
        assert client.stats["reconnects"] >= 2      # the first connect and the recovery
        assert server.stats["msgs_recv"] == 4
    finally:
        client.close()
        server.close()


# ---------------------------------------------------------------------------
# keyframe conversions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kf():
    """A keyframe's JAX features (numpy) and its pose tangent."""
    _, _, _, feats = mapping_scene()
    return feats[0], MKF_TANGENTS[0]


@pytest.mark.parametrize("jpeg_quality", [90, 0])
def test_feats_to_arrays_matches(kf, jpeg_quality):
    feats, v = kf
    jd = jnet.feats_to_arrays(jax.tree_util.tree_map(jnp.asarray, feats),
                              JSE3.exp(jnp.asarray(v)), jpeg_quality=jpeg_quality)
    pd = pnet.feats_to_arrays(convert.frame_features_from_numpy(feats, device="cpu"),
                              SE3.exp(torch.as_tensor(v)), jpeg_quality=jpeg_quality)
    assert ("img0" in pd) == (jpeg_quality > 0) and ("atlas" in pd) == (jpeg_quality == 0)
    assert list(pd) == list(jd)
    for k in jd:
        assert pd[k].dtype == np.asarray(jd[k]).dtype, k
        if k.startswith("pose_"):      # the two packages' SE3.exp, f32
            np.testing.assert_allclose(pd[k], jd[k], rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(pd[k], jd[k], err_msg=k)


@pytest.mark.parametrize("wire", [False, True])
def test_arrays_to_feats_matches(kf, wire):
    """The receiver's features, from the same arrays in both packages: the
    atlas rebuilt from the level-0 image bit for bit (through the wire, from
    the same decoded JPEG planes), every other field as it was sent."""
    feats, v = kf
    d = jnet.feats_to_arrays(jax.tree_util.tree_map(jnp.asarray, feats),
                             JSE3.exp(jnp.asarray(v)))
    d = {k: np.asarray(a) for k, a in d.items()}
    if wire:
        d = pcodec.unpack_arrays(pcodec.pack_arrays(d, jpeg_keys=("img0",)))
    jf, jp = jnet.arrays_to_feats(d)
    pf, pp = pnet.arrays_to_feats(d, torch.device("cpu"))
    assert pf.atlas.device.type == "cpu"
    jf = np_get(jf)
    for name in ("atlas", "corner_atlas", "thresholds", "corner_counts", "sbi",
                 "sbi_gx", "sbi_gy"):
        np.testing.assert_array_equal(n(getattr(pf, name)), getattr(jf, name), err_msg=name)
    for name in ("cand_xy", "cand_score", "cand_valid"):
        for l, (a, b) in enumerate(zip(getattr(pf, name), getattr(jf, name))):
            assert n(a).dtype == b.dtype, (name, l)
            np.testing.assert_array_equal(n(a), b, err_msg=f"{name}[{l}]")
    np.testing.assert_array_equal(n(pp.R), np.asarray(jp.R))
    np.testing.assert_array_equal(n(pp.t), np.asarray(jp.t))
    if not wire:                       # the level-0 image is exact: so is the atlas
        np.testing.assert_array_equal(n(pf.atlas), feats.atlas)


# ---------------------------------------------------------------------------
# the client's map-maker without a tracker (tests/test_distributed.py's
# fast cases)
# ---------------------------------------------------------------------------

@pytest.fixture
def loopback():
    server, client = _channels(pnet, pnet)
    yield server, client
    client.close()
    server.close()


def _port_rig():
    cams, cfb, _, _, _ = jax_scene()
    return (convert.camera_from_numpy(np_get(cams), device="cpu"),
            convert.se3_from_numpy(np_get(cfb), device="cpu"))


def test_client_step_accepts_frame_budget(loopback):
    """System.process_frame calls mapmaker.step(ms, budget_s=...): the
    client's step takes the budget, and the positional form."""
    _, client_ch = loopback
    cams, cfb = _port_rig()
    mm = pnet.MapMakerClient(client_ch, cams)
    ms = p_create(H, W, C, cfb, **SMALL)
    for budget in (None, 0.01):
        ms2 = mm.step(ms, budget_s=budget)
        assert ms2.points.capacity == ms.points.capacity
    assert mm.step(ms).mkfs.capacity == ms.mkfs.capacity


def test_monitor_relay_fast(loopback):
    """ACTION_MONITOR carries the client's pose, quality and small image to
    the server's store (ref SystemServer.cc:113-136)."""
    server_ch, client_ch = loopback
    cams, cfb = _port_rig()
    server = pnet.MapServer(server_ch, cams, p_create(H, W, C, cfb, **SMALL))
    mm = pnet.MapMakerClient(client_ch, cams)
    mm.send_monitor({
        "pose": np.eye(3, 4, dtype=np.float32),
        "quality": np.asarray(1, np.int32),
        "lost": np.asarray(False),
        "n_found": np.asarray(123, np.int32),
        "small_image": np.full((6, 8, 3), 7, np.uint8),
    })
    server.handle_message(*_poll(server_ch))
    assert server.monitor_count == 1
    mon = server.client_monitor
    assert int(np.asarray(mon["n_found"]).ravel()[0]) == 123
    assert mon["small_image"].shape == (6, 8, 3)
    assert not bool(np.asarray(mon["lost"]).reshape(()))


def test_manual_add_while_initialising_has_no_stop_init(loopback):
    """ManualAddMKF while the map initialises asks the map-maker to stop
    its initialisation; MapMakerClient has no stop_init, so the command
    raises in both packages (ROADMAP section C, kept as the reference
    has it)."""
    _, client_ch = loopback
    jcams, jcfb, jcams_sbi, _, _ = jax_scene()
    jsys = JSystem(jcams, jcfb, jcams_sbi, H, W, mapmaker=jnet.MapMakerClient(client_ch, jcams),
                   **SMALL)
    cams, cfb = _port_rig()
    psys = System(cams, cfb, convert.camera_from_numpy(np_get(jcams_sbi), device="cpu"), H, W,
                  mapmaker=pnet.MapMakerClient(client_ch, cams), **SMALL)
    assert jsys.mapmaker.state == psys.mapmaker.state == 0      # MM_INITIALIZING
    with pytest.raises(AttributeError, match="stop_init"):
        jsys.parse_line("ManualAddMKF")
    with pytest.raises(AttributeError, match="stop_init"):
        psys.parse_line("ManualAddMKF")
    # once the server reports MM_RUNNING, the command queues an add
    jsys.mapmaker.state = psys.mapmaker.state = 1
    jsys.parse_line("ManualAddMKF")
    psys.parse_line("ManualAddMKF")
    assert jsys._force_add_next and psys._force_add_next


def test_map_update_roundtrip(loopback):
    """A server map's UPDATE applied on a client map: every section equal,
    in the client map's dtypes, next_seq back to a scalar."""
    _, _, ms_np, _ = mapping_scene()
    src = convert.map_state_from_numpy(ms_np, device="cpu")
    src.next_seq = torch.tensor(5, dtype=torch.int32)
    cams, cfb = _port_rig()
    dst = p_create(H, W, C, cfb, src.points.capacity, src.mkfs.capacity, src.meas.capacity)
    wire = pcodec.unpack_arrays(pcodec.pack_arrays(pnet.map_update_arrays(src)))
    assert wire["next_seq"].shape == (1,)
    dst = pnet.apply_map_update(dst, wire)
    a, b = convert.to_numpy(dst), convert.to_numpy(src)
    for sec in ("points", "meas"):
        for k, v in a[sec].items():
            assert v.dtype == b[sec][k].dtype, k
            np.testing.assert_array_equal(v, b[sec][k], err_msg=f"{sec}.{k}")
    for k in ("valid", "fixed", "seq", "scene_depth_mean", "scene_depth_sigma"):
        np.testing.assert_array_equal(a["mkfs"][k], b["mkfs"][k], err_msg=k)
    np.testing.assert_array_equal(a["mkfs"]["base_from_world"]["R"],
                                  b["mkfs"]["base_from_world"]["R"])
    assert dst.next_seq.shape == () and int(dst.next_seq) == 5
    # the JAX client reads the port server's UPDATE the same way
    jms = jnet.apply_map_update(j_create(H, W, C, jax_scene()[1], src.points.capacity,
                                         src.mkfs.capacity, src.meas.capacity), wire)
    np.testing.assert_array_equal(np.asarray(jms.points.pos_w), b["points"]["pos_w"])
    np.testing.assert_array_equal(np.asarray(jms.meas.source), b["meas"]["source"])
    assert int(jms.next_seq) == 5


def test_stale_update_frees_a_committed_keyframe(loopback, kf):
    """ROADMAP section C, kept as the reference has it: the client commits
    a queued MKF and ships it; an UPDATE the server sent before it
    integrated that MKF marks the slot free again, in both packages."""
    _, client_ch = loopback
    feats, v = kf
    jcams, jcfb, _, _, _ = jax_scene()
    cams, cfb = _port_rig()
    jmm = jnet.MapMakerClient(client_ch, jcams)
    pmm = pnet.MapMakerClient(client_ch, cams)
    jmm.add_mkf(jax.tree_util.tree_map(jnp.asarray, feats), JSE3.exp(jnp.asarray(v)), None)
    pmm.add_mkf(convert.frame_features_from_numpy(feats, device="cpu"),
                SE3.exp(torch.as_tensor(v)), None)
    jms = jmm.step(j_create(H, W, C, jcfb, **SMALL))
    pms = pmm.step(p_create(H, W, C, cfb, **SMALL))
    assert bool(jms.mkfs.valid[0]) and bool(pms.mkfs.valid[0])
    stale = pnet.map_update_arrays(p_create(H, W, C, cfb, **SMALL))
    jms = jnet.apply_map_update(jms, stale)
    pms = pnet.apply_map_update(pms, stale)
    assert not bool(jms.mkfs.valid[0]) and not bool(pms.mkfs.valid[0])
