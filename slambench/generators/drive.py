"""The generator of the `drive` mixes: a street world from the seed, its
frames, the arguments the entry takes and the feed's schedule.

A mix file (`slambench/mixes/<name>.json`) names its generator under
`generator` and gives it its parameters: `speed_m_per_frame`,
`yaw_rate_rad_per_m`, `corridor_half_width_m`, the world's length in frames
(`world_frames`: the same seed gives the same world whatever the run's
length), the untimed pre-roll (`preroll_frames`), `ahead_frames_per_s`, the
rate the window's frames are rendered for, and `feed`: `{"kind": "closed"}`
hands in the next frame as soon as the call returns (a dataset replay),
`{"kind": "rate", "frames_per_s": r}` hands frame k of the window in at k / r
seconds after it opens, or as soon as the system is free after that (a live
camera). Frames are rendered on the device in batches and handed to the
program from the host, as a camera driver or a dataset reader hands them: a
stereo frame is (left, right), a monocular one the left image alone.

Every generator module has `make(mix, spec, seed, seconds, tail_frames,
device)`, returning an object with the attributes and methods of `Drive`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from slambench import reference
from slambench import world as world_mod

RENDER_BATCH = 16  # images per ray-cast call
SENSOR_IMAGES = {"stereo": 2, "monocular": 1}


class Drive:
    """One run's traffic: `preroll` frames tracked untimed, then the window's
    frames, `n_frames` in all, with their ground-truth poses (Tcw) and
    timestamps."""

    def __init__(self, mix: dict, spec: dict, seed: int, seconds: float, tail_frames: int, device):
        sensor = spec["sensor"]
        if sensor not in SENSOR_IMAGES:
            raise ValueError(f"the drive renders no input for a {sensor!r} sensor")
        cam = world_mod.Camera.from_config(spec)
        self.preroll = int(mix["preroll_frames"])
        feed = mix["feed"]
        if feed["kind"] not in ("closed", "rate"):
            raise ValueError(f"unknown feed {feed['kind']!r}")
        self._period_s = 1.0 / float(feed["frames_per_s"]) if feed["kind"] == "rate" else None
        self.world = world_mod.make_world(
            seed, int(mix["world_frames"]), cam, device, speed=float(mix["speed_m_per_frame"]),
            yaw_rate=float(mix["yaw_rate_rad_per_m"]), corridor_half_width=float(mix["corridor_half_width_m"]))
        wanted = self.preroll + math.ceil(float(mix["ahead_frames_per_s"]) * seconds) + tail_frames
        self.n_frames = min(wanted, self.world.num_frames)
        stereo = SENSOR_IMAGES[sensor] == 2
        poses = self.world.poses[: self.n_frames]
        self.frames = np.empty((self.n_frames, SENSOR_IMAGES[sensor], cam.height, cam.width), np.uint8)
        for lo in range(0, self.n_frames, RENDER_BATCH):
            hi = min(lo + RENDER_BATCH, self.n_frames)
            self.frames[lo:hi, 0] = world_mod.render(self.world, poses[lo:hi], device).cpu().numpy()
            if stereo:
                self.frames[lo:hi, 1] = world_mod.render(
                    self.world, self.world.right_poses(poses[lo:hi]), device).cpu().numpy()
        # the textures serve no request once the frames exist
        for surf in self.world.surfaces:
            surf.mips = []

    @property
    def poses(self) -> np.ndarray:
        return self.world.poses[: self.n_frames]

    @property
    def timestamps(self) -> np.ndarray:
        return self.world.timestamps[: self.n_frames]

    def frame(self, f: int) -> Tuple[np.ndarray, ...]:
        """The entry's arguments for frame f, before its timestamp."""
        return tuple(self.frames[f])

    def images(self, f: int) -> np.ndarray:
        """The raw images of frame f that the front-end runs on, (I, H, W) uint8."""
        return self.frames[f]

    def due_s(self, k: int) -> Optional[float]:
        """When the window's k-th frame arrives, in seconds after it opens;
        None in a closed loop (as soon as the previous call returns)."""
        return None if self._period_s is None else k * self._period_s

    def surface_distance(self, points_w: np.ndarray) -> np.ndarray:
        """Distance of each (N, 3) ground-truth-world point to the world's
        nearest surface."""
        w = self.world
        return reference.surface_distance(points_w, w.center, w.r_inner, w.r_outer, w.ground_y)


def make(mix: dict, spec: dict, seed: int, seconds: float, tail_frames: int, device) -> Drive:
    return Drive(mix, spec, seed, seconds, tail_frames, device)
