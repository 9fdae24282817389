"""SystemClient: the on-board tracking process of the client/server split
(port of mcptam_tpu/system/client.py).

The reference's mcptam_client binary (src/MainClient.cc, src/SystemClient.cc)
runs the standalone System's grab->track->publish loop with MapMakerClient
forwarding map building to an off-board server.  Here SystemClient is the
System with the network MapMakerClient in place of the MapMaker; the
transport is the native framed-TCP channel (native/netmanager.cc).

The client's capacities (max_points, max_mkfs, max_meas) must be the
server's: slot consistency rests on both sides committing MKFs in message
order into identical fixed-capacity stores.
"""

from __future__ import annotations

import numpy as np

from mcptam_tpu_torch.config import (
    DEFAULT_MAPMAKER, DEFAULT_TRACKER, MAX_MEAS, MAX_MKFS, MAX_POINTS,
    MapMakerConfig, TrackerConfig,
)
from mcptam_tpu_torch.system.network import Channel, MapMakerClient
from mcptam_tpu_torch.system.system import System


class SystemClient(System):
    """The System loop with its map-maker in another process."""

    def __init__(self, cams, cam_from_base, cams_sbi, H, W,
                 server_host: str, server_port: int,
                 tcfg: TrackerConfig = DEFAULT_TRACKER,
                 mcfg: MapMakerConfig = DEFAULT_MAPMAKER,
                 max_points: int = MAX_POINTS, max_mkfs: int = MAX_MKFS,
                 max_meas: int = MAX_MEAS, masks=None,
                 monitor_interval: int = 5):
        self.channel = Channel.connect(server_host, server_port)
        # every Nth frame the client relays its pose, quality and the tiled
        # small image so the server's operator can watch tracking (the
        # reference SystemServer mirrors the client's system_info and
        # small_image topics, src/SystemServer.cc:113-136); 0 disables
        self.monitor_interval = monitor_interval
        super().__init__(cams, cam_from_base, cams_sbi, H, W, tcfg, mcfg,
                         max_points, max_mkfs, max_meas,
                         mapmaker=MapMakerClient(self.channel, cams), masks=masks)

    def process_frame(self, images, cam_active=None):
        info = super().process_frame(images, cam_active=cam_active)
        if self.monitor_interval and self.frame_count % self.monitor_interval == 0:
            small = self.small_image()
            self.mapmaker.send_monitor({
                "pose": np.asarray(info.pose, np.float32),
                "quality": np.asarray(info.quality, np.int32),
                "lost": np.asarray(info.lost),
                "n_found": np.asarray(info.n_found, np.int32),
                "small_image": (small if small is not None
                                else np.zeros((1, 1, 3), np.uint8)),
            })
        return info

    def close(self):
        self.channel.close()
