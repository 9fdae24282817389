"""Client/server mapping: tracking on board, map optimisation off board
(port of mcptam_tpu/system/network.py).

The reference splits into mcptam_client / mcptam_server ROS nodes that
exchange the ModifyMap service (SURVEY section 2.7; src/MapMakerClient.cc,
src/MapMakerServer.cc, src/NetworkManager.cc).  Here:

  * transport = the native C++ framed-TCP manager with retry-forever
    semantics (native/netmanager.cc);
  * payloads = zlib'd numpy array packs (system/netcodec.py) keeping the
    ADD/UPDATE/DELETE/OUTLIERS/INIT/RESET/STATE action vocabulary, byte for
    byte the JAX package's;
  * slot consistency replaces the reference's pointer<->string-id
    Dictionary: both sides commit MKFs in message order into identical
    fixed-capacity stores, and the server's point and measurement sections
    are applied wholesale on the client (imagery never travels back).

Arrays that arrive land on the receiving map's device.  The client API
mirrors MapMakerClientBase (a blocking init, asynchronous adds,
src/MapMakerClientBase.h:129-143); the server loop mirrors
MapMakerServer::run's priority order (network first, then the map-maker,
src/MapMakerServer.cc:95-227).
"""

from __future__ import annotations

import ctypes
import logging
import time
from dataclasses import dataclass

import numpy as np
import torch

from mcptam_tpu_torch.config import DEFAULT_MAPMAKER, LEVELS
from mcptam_tpu_torch.core.se3 import SE3
from mcptam_tpu_torch.map.builder import commit_mkf
from mcptam_tpu_torch.map.keyframe import FrameFeatures
from mcptam_tpu_torch.map.mapmaker_core import record_tracker_measurements
from mcptam_tpu_torch.map.state import (
    MapState, count_points, create_map_state, move_bad_points_to_trash,
)
from mcptam_tpu_torch.native.build import load
from mcptam_tpu_torch.ops.atlas import _level0_width_from_atlas, build_atlas
from mcptam_tpu_torch.ops.pyramid import build_pyramid
from mcptam_tpu_torch.system.mapio import dump_map_ascii
from mcptam_tpu_torch.system.mapmaker import MM_INITIALIZING, MapMaker
from mcptam_tpu_torch.system.netcodec import (
    ACTION_ADD, ACTION_DELETE, ACTION_INIT, ACTION_MONITOR, ACTION_OUTLIERS,
    ACTION_RESET, ACTION_STATE, ACTION_UPDATE, JPEG_QUALITY, pack_arrays,
    unpack_arrays,
)

_log = logging.getLogger(__name__)

INIT_TIMEOUT_S = 120.0   # how long a client waits for the server's INIT answer
POLL_BUFFER = 1 << 20    # a poll's first buffer; larger messages retry at their size


class Channel:
    """Framed-message channel over the native net manager."""

    def __init__(self, handle, lib):
        self._handle = handle
        self._lib = lib
        self.port = None

    @property
    def _h(self):
        if not self._handle:
            raise RuntimeError("the channel is closed")
        return self._handle

    @classmethod
    def serve(cls, port: int = 0) -> "Channel":
        """Listen on ``port`` of the loopback interface (0: an ephemeral port
        the kernel picks; read ``.port``)."""
        lib = load("netmanager")
        h = lib.nm_create_server(port)
        if not h:
            raise OSError(f"cannot listen on port {port}")
        ch = cls(h, lib)
        ch.port = int(lib.nm_port(h))
        return ch

    @classmethod
    def connect(cls, host: str, port: int) -> "Channel":
        """A client channel; it connects in the background and retries until
        the server is there."""
        lib = load("netmanager")
        return cls(lib.nm_create_client(host.encode(), port), lib)

    def send(self, action: int, arrays: dict | None = None) -> bytes:
        """Queue a message; keyframe imagery (``img0``) rides as JPEG planes
        (the reference's NetworkManager, quality 90).  Returns the packed
        payload."""
        blob = pack_arrays(arrays or {}, jpeg_keys=("img0",))
        buf = (ctypes.c_uint8 * len(blob)).from_buffer_copy(blob)
        self._lib.nm_send(self._h, action, buf, len(blob))
        return blob

    def poll(self, timeout_ms: int = 0):
        """The next message as (action, arrays), or None after
        ``timeout_ms``."""
        size = self._lib.nm_peek_size(self._h)
        cap = max(int(size), POLL_BUFFER)
        while True:
            buf = (ctypes.c_uint8 * cap)()
            action = ctypes.c_uint32()
            n = self._lib.nm_poll(self._h, ctypes.byref(action), buf, cap, timeout_ms)
            if n == -1:
                return None
            if n < -1:   # larger than the buffer: retry at its exact size
                cap = -int(n) - 2
                continue
            return int(action.value), unpack_arrays(bytes(buf[: int(n)]))

    @property
    def stats(self) -> dict:
        """Send and receive accounting (ref NetworkManager.h:298-303)."""
        out = (ctypes.c_uint64 * 5)()
        self._lib.nm_stats(self._h, out)
        return {
            "msgs_sent": int(out[0]), "msgs_recv": int(out[1]),
            "bytes_sent": int(out[2]), "bytes_recv": int(out[3]),
            "reconnects": int(out[4]),
        }

    def break_connection(self):
        """Force the live connection down (a partition); queued messages are
        delivered after the automatic reconnect."""
        self._lib.nm_break(self._h)

    def close(self):
        if self._handle:
            self._lib.nm_destroy(self._handle)
            self._handle = None


# ---------------------------------------------------------------------------
# FrameFeatures / pose / tracker-result array conversion
# ---------------------------------------------------------------------------

def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _tensor(a, device, dtype=None) -> torch.Tensor:
    """A received array as a tensor of its own on ``device``."""
    return torch.tensor(np.asarray(a)).to(device, dtype)


def feats_to_arrays(feats: FrameFeatures, pose: SE3,
                    jpeg_quality: int = JPEG_QUALITY) -> dict:
    """A keyframe's features and pose as numpy arrays.  jpeg_quality > 0:
    only the level-0 image travels (``img0``, JPEG planes on the wire),
    as the reference sends the level-0 image at quality 90 and re-derives
    the rest server-side (src/NetworkManager.cc:804-805); the receiver
    rebuilds the pyramid atlas.  0: the whole atlas travels losslessly."""
    if jpeg_quality > 0:
        W = _level0_width_from_atlas(feats.atlas.shape[-1])
        d = {"img0": _np(torch.clamp(feats.atlas[..., :W], 0, 255).to(torch.uint8))}
    else:
        d = {"atlas": _np(torch.clamp(feats.atlas, 0, 255).to(torch.uint8))}
    d.update({
        "corner_atlas": _np(feats.corner_atlas > 0.5).astype(np.uint8),
        "thresholds": _np(feats.thresholds),
        "corner_counts": _np(feats.corner_counts),
        "sbi": _np(feats.sbi),
        "sbi_gx": _np(feats.sbi_gx),
        "sbi_gy": _np(feats.sbi_gy),
        "pose_R": _np(pose.R),
        "pose_t": _np(pose.t),
    })
    for l in range(LEVELS):
        d[f"cand_xy_{l}"] = _np(feats.cand_xy[l])
        d[f"cand_score_{l}"] = _np(feats.cand_score[l])
        d[f"cand_valid_{l}"] = _np(feats.cand_valid[l])
    return d


def arrays_to_feats(d: dict, device):
    """(FrameFeatures, pose) on ``device`` from ``feats_to_arrays``' arrays;
    from ``img0`` the pyramid atlas is rebuilt (the half-sample kernel on a
    CUDA device)."""
    def dev(a, dtype=None):
        return _tensor(a, device, dtype)

    if "atlas" in d:
        atlas = dev(d["atlas"], torch.float32)
    else:
        atlas = build_atlas(build_pyramid(dev(d["img0"], torch.float32)))
    feats = FrameFeatures(
        atlas=atlas,
        corner_atlas=dev(d["corner_atlas"], torch.float32),
        thresholds=dev(d["thresholds"]),
        corner_counts=dev(d["corner_counts"]),
        cand_xy=tuple(dev(d[f"cand_xy_{l}"]) for l in range(LEVELS)),
        cand_score=tuple(dev(d[f"cand_score_{l}"]) for l in range(LEVELS)),
        cand_valid=tuple(dev(d[f"cand_valid_{l}"]) for l in range(LEVELS)),
        sbi=dev(d["sbi"]), sbi_gx=dev(d["sbi_gx"]), sbi_gy=dev(d["sbi_gy"]),
    )
    return feats, SE3(R=dev(d["pose_R"]), t=dev(d["pose_t"]))


_RESULT_FIELDS = ("sel_point", "sel_cam", "sel_level", "sel_pos_l0",
                  "sel_found", "sel_outlier", "sel_subpix")


def result_to_arrays(res) -> dict:
    return {f: _np(getattr(res, f)) for f in _RESULT_FIELDS}


@dataclass
class TrackResultView:
    """The slice of a tracker result an ADD carries: the fields the
    server's integration reads (record_tracker_measurements).  The
    reference once dropped every tracker measurement on the server when its
    view was refused by the integration; the port's integration reads plain
    tensors, so a dataclass of them is enough."""

    sel_point: torch.Tensor
    sel_cam: torch.Tensor
    sel_level: torch.Tensor
    sel_pos_l0: torch.Tensor
    sel_found: torch.Tensor
    sel_outlier: torch.Tensor
    sel_subpix: torch.Tensor

    @classmethod
    def from_dict(cls, d: dict, device) -> "TrackResultView":
        return cls(**{f: _tensor(d[f], device) for f in _RESULT_FIELDS})


# ---------------------------------------------------------------------------
# Map-section snapshots (server -> client)
# ---------------------------------------------------------------------------

_POINT_FIELDS = [
    "pos_w", "valid", "bad", "fixed", "optimized", "src_mkf",
    "src_cam", "src_level", "center_xy", "src_window", "src_window_ok",
    "center_nc", "right_nc", "down_nc",
    "pixel_right_w", "pixel_down_w", "in_count", "out_count",
]
_MEAS_FIELDS = ["mkf", "cam", "point", "level", "uv_l0", "valid", "source", "subpix"]


def map_update_arrays(ms: MapState) -> dict:
    """The server's point and measurement sections and MKF poses."""
    d = {}
    for f in _POINT_FIELDS:
        d[f"pt_{f}"] = _np(getattr(ms.points, f))
    for f in _MEAS_FIELDS:
        d[f"ms_{f}"] = _np(getattr(ms.meas, f))
    d["mkf_R"] = _np(ms.mkfs.base_from_world.R)
    d["mkf_t"] = _np(ms.mkfs.base_from_world.t)
    d["mkf_valid"] = _np(ms.mkfs.valid)
    d["mkf_fixed"] = _np(ms.mkfs.fixed)
    d["mkf_seq"] = _np(ms.mkfs.seq)
    d["mkf_depth_mean"] = _np(ms.mkfs.scene_depth_mean)
    d["mkf_depth_sigma"] = _np(ms.mkfs.scene_depth_sigma)
    d["next_seq"] = _np(ms.next_seq)
    return d


def apply_map_update(ms: MapState, d: dict) -> MapState:
    """Apply an UPDATE: every section replaced wholesale, in the receiving
    map's dtypes and on its device.  Updates ms in place."""
    def like(a, ref: torch.Tensor):
        return _tensor(a, ref.device, ref.dtype).reshape(ref.shape)

    for f in _POINT_FIELDS:
        setattr(ms.points, f, like(d[f"pt_{f}"], getattr(ms.points, f)))
    for f in _MEAS_FIELDS:
        setattr(ms.meas, f, like(d[f"ms_{f}"], getattr(ms.meas, f)))
    mk = ms.mkfs
    mk.base_from_world = SE3(R=like(d["mkf_R"], mk.base_from_world.R),
                             t=like(d["mkf_t"], mk.base_from_world.t))
    mk.valid = like(d["mkf_valid"], mk.valid)
    mk.fixed = like(d["mkf_fixed"], mk.fixed)
    mk.seq = like(d["mkf_seq"], mk.seq)
    mk.scene_depth_mean = like(d["mkf_depth_mean"], mk.scene_depth_mean)
    mk.scene_depth_sigma = like(d["mkf_depth_sigma"], mk.scene_depth_sigma)
    # the codec sends 0-d scalars as shape (1,): back to the scalar shape
    ms.next_seq = like(d["next_seq"], ms.next_seq)
    return ms


def _scalar(a):
    """A codec scalar (shape (1,)) as a numpy scalar."""
    return np.asarray(a).ravel()[0]


# ---------------------------------------------------------------------------
# Client-side map maker
# ---------------------------------------------------------------------------

class MapMakerClient:
    """The tracker side's map-maker: MKF imagery committed locally, every
    map change made by the server (ref src/MapMakerClient.cc).  It stands
    in for System's MapMaker: ``init``, ``add_mkf``, ``queue``, ``step``,
    ``reset``, ``state``, ``reset_requested``, ``on_map_changed``."""

    def __init__(self, channel: Channel, cams):
        self.channel = channel
        self.cams = cams
        self.state = MM_INITIALIZING
        self.init_point_cov = float("inf")
        self.queue = []
        self._server_reset = False

    def init(self, ms: MapState, feats, pose):
        """Blocking INIT (the reference's CallInit blocks until the server
        built the first points, src/MapMakerClient.cc:181).  Returns
        (ms, ok); ok is False when the server's init made no points (its
        snMinMapPoints gate)."""
        ms, _, _ = commit_mkf(ms, feats, pose, fixed=True)
        self.channel.send(ACTION_INIT, feats_to_arrays(feats, pose))
        deadline = time.time() + INIT_TIMEOUT_S
        while time.time() < deadline:
            msg = self.channel.poll(timeout_ms=200)
            if msg is None:
                continue
            action, d = msg
            if action == ACTION_UPDATE:
                ms = apply_map_update(ms, d)
                return ms, int(count_points(ms)) > 0
            if action == ACTION_STATE:
                self._apply_state(d)
        raise TimeoutError("server did not answer INIT")

    def add_mkf(self, feats, pose, tracker_result, cam_active=None):
        self.queue.append((feats, pose, tracker_result, cam_active))

    def queue_size(self) -> int:
        return len(self.queue)

    def reset(self, ms=None):
        self.queue.clear()
        self.state = MM_INITIALIZING
        if self._server_reset:
            self._server_reset = False   # server-initiated: do not bounce it back
        else:
            self.channel.send(ACTION_RESET)

    def on_map_changed(self):
        pass

    @property
    def reset_requested(self) -> bool:
        """Resets come from the server in client/server mode (ref
        RequestResetInternal -> the client's reset service)."""
        return self._server_reset

    def send_deletes(self, point_idx: np.ndarray):
        """Tracker-outlier deletions (ref HandleBadPoints -> SendDelete)."""
        self.channel.send(ACTION_DELETE, {"points": np.asarray(point_idx)})

    def send_monitor(self, d: dict):
        """Operator-monitoring relay: tracker pose and quality and the small
        image (the reference server mirrors the client's system_info and
        small_image topics, src/SystemServer.cc:113-136)."""
        self.channel.send(ACTION_MONITOR, d)

    def _apply_state(self, d):
        self.state = int(_scalar(d["state"]))
        self.init_point_cov = float(_scalar(d["init_cov"]))

    def step(self, ms: MapState, budget_s: float | None = None) -> MapState:
        """Forward one queued MKF, drain the server's messages, and send the
        tracker's bad points as a DELETE.  ``budget_s`` is accepted for
        System's call and unused: the client runs no BA, and this is one
        bounded pass (ref MapMakerClient::run, src/MapMakerClient.cc:96-129)."""
        # 1. one queued MKF: imagery committed locally (the slot the server
        # will use), tracker measurements recorded, then shipped
        if self.queue:
            feats, pose, result, cam_active = self.queue.pop(0)
            ms, mkf_idx, _ = commit_mkf(ms, feats, pose, kf_valid=cam_active)
            d = feats_to_arrays(feats, pose)
            if result is not None:
                ms = record_tracker_measurements(ms, mkf_idx, result)
                d.update(result_to_arrays(result))
            if cam_active is not None:
                d["cam_active"] = _np(torch.as_tensor(cam_active))
            self.channel.send(ACTION_ADD, d)

        # 2. the server's messages
        while (msg := self.channel.poll(timeout_ms=0)) is not None:
            action, d = msg
            if action == ACTION_UPDATE:
                ms = apply_map_update(ms, d)
            elif action == ACTION_OUTLIERS:
                bad = _tensor(d["meas_outlier"], ms.meas.valid.device, torch.bool)
                ms.meas.valid = ms.meas.valid & ~bad
            elif action == ACTION_STATE:
                self._apply_state(d)
            elif action == ACTION_RESET:
                # the server's BA failure chain (MapMakerServerBase::
                # RequestResetInternal -> the client's reset service)
                self._server_reset = True

        # 3. tracker-flagged bad points: DELETE to the server, then the local
        # trash pass (ref MapMakerClient::HandleBadPoints -> SendDelete,
        # src/MapMakerClient.cc:158-181)
        bad = ms.points.bad & ms.points.valid
        if bool(torch.any(bad)):
            self.send_deletes(_np(torch.nonzero(bad).reshape(-1)))
            ms = move_bad_points_to_trash(ms)
        return ms


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

class MapServer:
    """The off-board map-maker process (ref src/MapMakerServer.cc)."""

    def __init__(self, channel: Channel, cams, ms_template: MapState, mcfg=None):
        self.channel = channel
        self.cams = cams
        self.ms = ms_template
        self.mapmaker = MapMaker(cams=cams, mcfg=mcfg or DEFAULT_MAPMAKER)
        self._dirty = False
        # the map-maker ticks only once the map is initialised (ref
        # MapMaker::run skips its loop until the map is good); see spin_once
        self.initialised = False
        # the client's last operator-monitoring packet (pose, quality, small
        # image; ref SystemServer mirrors the client's topics,
        # src/SystemServer.cc:113-136)
        self.client_monitor: dict | None = None
        self.monitor_count = 0

    @property
    def device(self) -> torch.device:
        return self.ms.mkfs.valid.device

    def _send_state(self):
        self.channel.send(ACTION_STATE, {
            "state": np.asarray(self.mapmaker.state, np.int32),
            "init_cov": np.asarray(self.mapmaker.init_point_cov, np.float64),
        })

    def _send_update(self):
        self.channel.send(ACTION_UPDATE, map_update_arrays(self.ms))
        self._send_state()

    def handle_message(self, action: int, d: dict):
        if action == ACTION_INIT:
            feats, pose = arrays_to_feats(d, self.device)
            self.ms, self.initialised = self.mapmaker.init(self.ms, feats, pose)
            self._send_update()
        elif action == ACTION_ADD:
            feats, pose = arrays_to_feats(d, self.device)
            result = (TrackResultView.from_dict(d, self.device)
                      if "sel_point" in d else None)
            cam_active = (_tensor(d["cam_active"], self.device, torch.bool)
                          if "cam_active" in d else None)
            self.mapmaker.add_mkf(feats, pose, result, cam_active=cam_active)
            self.mapmaker.on_map_changed()
        elif action == ACTION_DELETE:
            idx = _tensor(d["points"], self.device, torch.int64)
            self.ms.points.bad = self.ms.points.bad.index_fill(0, idx, True)
            self._dirty = True
        elif action == ACTION_MONITOR:
            self.client_monitor = d
            self.monitor_count += 1
        elif action == ACTION_RESET:
            self._reset()

    def _reset(self):
        self.initialised = False
        self.ms = self._fresh_map()
        self.mapmaker.reset(self.ms)
        self._send_state()

    def _fresh_map(self) -> MapState:
        """An empty map of the same rig and capacities."""
        H = self.ms.mkfs.atlas.shape[2]
        W = _level0_width_from_atlas(self.ms.mkfs.atlas.shape[3])
        C = self.ms.cam_from_base.t.shape[0]
        return create_map_state(H, W, C, self.ms.cam_from_base,
                                self.ms.points.capacity, self.ms.mkfs.capacity,
                                self.ms.meas.capacity)

    def spin_once(self, timeout_ms: int = 10) -> bool:
        """One server-loop iteration: a message if one arrives, otherwise a
        map-maker tick, then an UPDATE and a STATE after an integrated MKF,
        a finished BA or a DELETE.  Returns False when idle.

        Before a successful INIT the map-maker does not tick.  The JAX
        package's server does: its global BA of the empty map finishes and
        sends an UPDATE, which a client that connects later takes for the
        answer to its INIT (ROADMAP section C)."""
        msg = self.channel.poll(timeout_ms=timeout_ms)
        if msg is not None:
            self.handle_message(*msg)
            return True
        if not self.initialised:
            return False
        before = self.mapmaker._ba_kind
        n_q = self.mapmaker.queue_size()
        self.ms = self.mapmaker.step(self.ms)
        finished_ba = before != "none" and self.mapmaker._ba_kind == "none"
        if n_q > 0 or finished_ba or self._dirty:
            self._send_update()
            self._dirty = False
        if self.mapmaker.reset_requested:
            if self.mapmaker.mcfg.fail_dump_path:
                dump_map_ascii(self.mapmaker.mcfg.fail_dump_path, self.ms)
            self.channel.send(ACTION_RESET)
            self._reset()
        return n_q > 0 or before != "none"

    def run(self, stop_event=None):
        """The server loop, with the reference's retry-forever semantics
        (its NetworkManager thread, src/NetworkManager.cc:266-302): an
        exception from one iteration is logged with its traceback and the
        loop keeps serving."""
        while stop_event is None or not stop_event.is_set():
            try:
                self.spin_once(timeout_ms=20)
            except Exception:
                _log.exception("MapServer loop iteration failed; continuing")
                time.sleep(0.2)
