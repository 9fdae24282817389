"""Multi-camera video sources over the native synchronised frame queue
(port of mcptam_tpu/io/video_source.py; host numpy).

VideoSourceMulti analogue (ref src/VideoSourceMulti.cc): producers push
per-camera frames into the C++ frame queue (``native/framequeue.cc``), and
the tracker blocks on synchronised sets, the ApproximateTime pairing of
CameraGroupSubscriber without ROS.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from mcptam_tpu_torch.native.build import load


class SyncedFrameQueue:
    """Python face of the native queue: (C,H,W) uint8 frame sets."""

    def __init__(self, n_cams: int, H: int, W: int,
                 sync_tol: float = 5e-3, max_depth: int = 8):
        self._lib = load("framequeue")
        self.n_cams = n_cams
        self.H, self.W = H, W
        self.frame_bytes = H * W
        self._q = self._lib.fq_create(n_cams, self.frame_bytes, sync_tol, max_depth)

    def push(self, cam: int, timestamp: float, frame: np.ndarray):
        frame = np.ascontiguousarray(frame, np.uint8)
        if frame.nbytes != self.frame_bytes or not 0 <= cam < self.n_cams:
            raise ValueError(f"camera {cam}: a {frame.shape} frame does not fit "
                             f"a {self.n_cams}-camera {self.H}x{self.W} queue")
        self._lib.fq_push(self._q, cam, timestamp,
                          frame.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))

    def get(self, timeout_ms: int = -1):
        """Blocking synchronised read -> ((C,H,W) uint8, (C,) timestamps),
        or None on timeout."""
        buf = np.empty((self.n_cams, self.H, self.W), np.uint8)
        ts = np.empty(self.n_cams, np.float64)
        ok = self._lib.fq_get_synced(
            self._q, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), timeout_ms)
        if not ok:
            return None
        return buf, ts

    @property
    def dropped(self) -> int:
        return int(self._lib.fq_dropped(self._q))

    def set_dynamic_sync(self, enable: bool = True):
        """Adapt the sync tolerance to half the observed frame interval
        (ref sbDynamicSync, include/mcptam/CameraGroupSubscriber.h)."""
        self._lib.fq_set_dynamic(self._q, 1 if enable else 0)

    @property
    def effective_sync_tol(self) -> float:
        return float(self._lib.fq_effective_tol(self._q))

    def close(self):
        if self._q:
            self._lib.fq_destroy(self._q)
            self._q = None


class ReplaySource:
    """Feed a recorded sequence through the native queue, one producer
    thread a camera (the bag-replay stand-in).

    The producers push as fast as they can and the queue drops a camera's
    oldest frame when its ring is full, as a live camera must.  A replay
    holds every frame instead: its queue is as deep as the sequence is
    long, so a tracker slower than the producers still gets every frame.
    The reference's replay keeps the default depth of 8 and loses all but
    the newest 8 frames that wait (an intended divergence)."""

    def __init__(self, frames_by_cam, fps: float = 30.0, jitter: float = 1e-4,
                 timestamps=None):
        # frames_by_cam: (C,T,H,W) uint8; timestamps: optional (C,T)
        # recorded stamps (a dataset replay), else index / fps + jitter
        self.frames = np.asarray(frames_by_cam, np.uint8)
        C, T, H, W = self.frames.shape
        self.queue = SyncedFrameQueue(C, H, W, max_depth=max(T, 8))
        self.fps = fps
        self.jitter = jitter
        self.timestamps = (None if timestamps is None
                           else np.asarray(timestamps, np.float64))
        self._threads = []

    def start(self):
        rng = np.random.default_rng(0)
        C, T = self.frames.shape[:2]

        def feed(c):
            for t in range(T):
                if self.timestamps is not None:
                    ts = float(self.timestamps[c, t])
                else:
                    ts = t / self.fps + float(rng.normal() * self.jitter)
                self.queue.push(c, ts, self.frames[c, t])

        for c in range(C):
            th = threading.Thread(target=feed, args=(c,), daemon=True)
            th.start()
            self._threads.append(th)

    def join(self):
        for th in self._threads:
            th.join()
