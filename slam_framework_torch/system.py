"""SlamSystem façade for the stereo tracking slice of the port.

Port of slam_framework_tpu/system.py: construction from a config, the stereo
per-frame entry points (TrackStereo, slam_system.cpp:89-129), the young-map
reset, shutdown statistics and the KITTI trajectory export. Local mapping,
place recognition and loop closing are not ported yet, so there is no
vocabulary and no loop closer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from slam_framework_torch import resolve_device
from slam_framework_torch.config import SlamConfig
from slam_framework_torch.io import trajectory
from slam_framework_torch.map.arena import MapArena
from slam_framework_torch.pipeline.tracker import StereoTracker, TrackingState


class SlamSystem:
    """User-facing engine. One instance per camera stream, on one device."""

    RESET_IF_LOST_BELOW_KFS = 5  # tracker.cpp:613-620

    def __init__(self, cfg: SlamConfig, sensor: Optional[str] = None, sync_every: int = 4,
                 device: Optional[torch.device] = None):
        """device: where images, tracking state and the point block live.
        None means the first CUDA device and raises when there is none; the
        CPU is taken only when the caller passes it."""
        if sensor is not None and sensor != cfg.sensor:
            cfg = dataclasses.replace(cfg, sensor=sensor)
        if cfg.sensor != "stereo":
            raise ValueError(f"sensor {cfg.sensor!r} is not ported yet (stereo only)")
        self.cfg = cfg
        self.sync_every = sync_every
        self.device = resolve_device(device)
        self.n_resets = 0
        self._build()

    def _build(self) -> None:
        cfg = self.cfg
        self.arena = MapArena.create(cfg.capacity, cfg.capacity.max_features)
        self.tracker = StereoTracker(cfg, self.arena, sync_every=self.sync_every, device=self.device)

    def reset(self) -> None:
        """Tracker::Reset (tracker.cpp:225-246): clear map and state."""
        self.n_resets += 1
        self._build()

    def shutdown(self) -> dict:
        """Drain buffered frames; return run statistics (Shutdown :226-247)."""
        self.tracker.flush()
        return {
            "frames": len(self.tracker.records),
            "keyframes": self.arena.n_valid_kfs,
            "map_points": self.arena.n_valid_pts,
            "resets": self.n_resets,
        }

    def track_stereo(self, left: np.ndarray, right: np.ndarray, timestamp: float):
        """Per-frame stereo entry from host images. Returns the latest synced
        Tcw (lags up to sync_every frames) or None."""
        pose = self.tracker.track(left, right, timestamp)
        self._maybe_reset()
        return pose

    def track_stereo_device(self, pair: torch.Tensor, timestamp: float):
        """Stereo entry for a (2, H, W) uint8 pair already on the system's device."""
        pose = self.tracker.track_device(pair, timestamp)
        self._maybe_reset()
        return pose

    def _maybe_reset(self) -> None:
        # the reference resets on a young-map loss (tracker.cpp:613-620)
        if (
            self.tracker.state == TrackingState.LOST
            and self.arena.n_valid_kfs <= self.RESET_IF_LOST_BELOW_KFS
        ):
            self.reset()

    def frame_poses(self) -> np.ndarray:
        self.tracker.flush()
        return self.tracker.trajectory_poses()

    def save_trajectory_kitti(self, path: str) -> None:
        """Per-frame camera trajectory in KITTI format (slam_system.cpp:264-314)."""
        trajectory.save_kitti(path, self.frame_poses())
