"""Live map/trajectory publisher — the port's RosPublisher equivalent.

Copy of slam_framework_tpu/viz/publisher.py. The snapshot reads host numpy
only (the arena's arrays, the tracker's records and `_block_ids`), never a
CUDA tensor: a device read from this thread would synchronise the card under
the tracker's launches.

The reference's visualization layer is `RosPublisher` (src/ros/ros_publisher.{h,cpp}):
two inner threads that poll the map at ~1 kHz and publish (a) the full camera path
reconstructed from the tracker's relative-pose lists (ros_publisher.cpp:67-122) and
(b) the all-points / reference-points clouds (:124-216), applying the axis remap
(x,y,z) -> (z,-x,-y) (:110-117) to convert camera-convention coordinates into a
viewer frame. ROS itself is a hard build dependency there even when disabled
(SURVEY.md Appendix B item 8).

Here the publisher is dependency-free and sink-pluggable: one daemon thread snapshots
the host-side map arena + tracker records at a configurable rate and hands immutable
`Snapshot` objects to sinks (in-memory ring for tests/GUIs, JSONL stream for external
viewers, arbitrary callbacks). Like the reference, reads are lock-free against the
concurrently mutating map (the reference polls the same shared structures unlocked at
1 kHz); snapshots are therefore viz-grade, not consistency-grade. Consumers needing
settled state use the SlamSystem export APIs, which drain the pipeline first.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence

import numpy as np


def axis_remap(xyz: np.ndarray) -> np.ndarray:
    """Camera convention -> viewer frame: (x,y,z) -> (z,-x,-y).

    Matches the reference's hardcoded remap (ros_publisher.cpp:110-117), applied
    to both path positions and point clouds so viewers show z-forward motion as
    horizontal-plane travel."""
    xyz = np.asarray(xyz)
    out = np.empty_like(xyz)
    out[..., 0] = xyz[..., 2]
    out[..., 1] = -xyz[..., 0]
    out[..., 2] = -xyz[..., 1]
    return out


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """One published view of the live system state. Positions are in the viewer
    frame if the publisher's remap_axes is set (the reference always remaps)."""

    seq: int
    wall_time: float
    n_frames: int
    n_keyframes: int
    n_points: int
    path: np.ndarray        # (F,3) per-frame camera centers (GetCameraTrajectory)
    kf_positions: np.ndarray  # (K,3) keyframe camera centers
    points_all: np.ndarray  # (P,3) all valid map points (point_cloud_all)
    points_ref: np.ndarray  # (R,3) local-map points in the tracking block (point_cloud_ref)


class MemorySink:
    """Ring buffer of the latest snapshots (tests, in-process GUIs)."""

    def __init__(self, maxlen: int = 64):
        self.snapshots: deque[Snapshot] = deque(maxlen=maxlen)

    def publish(self, snap: Snapshot) -> None:
        self.snapshots.append(snap)

    @property
    def latest(self) -> Optional[Snapshot]:
        return self.snapshots[-1] if self.snapshots else None

    def close(self) -> None:
        pass


class CallbackSink:
    def __init__(self, fn: Callable[[Snapshot], None]):
        self.fn = fn

    def publish(self, snap: Snapshot) -> None:
        self.fn(snap)

    def close(self) -> None:
        pass


class JsonlSink:
    """Streams snapshots as JSON lines (external viewers / offline replay).

    Point clouds are downsampled to `max_points` per snapshot to bound line size;
    the path is always complete (it is what the reference's Path topic carries)."""

    def __init__(self, path: str, max_points: int = 2000):
        self.f = open(path, "w")
        self.max_points = max_points

    def publish(self, snap: Snapshot) -> None:
        def cloud(arr: np.ndarray) -> list:
            if len(arr) > self.max_points:
                idx = np.linspace(0, len(arr) - 1, self.max_points).astype(int)
                arr = arr[idx]
            return np.round(arr.astype(np.float64), 4).tolist()

        rec = {
            "seq": snap.seq,
            "t": snap.wall_time,
            "n_frames": snap.n_frames,
            "n_keyframes": snap.n_keyframes,
            "n_points": snap.n_points,
            "path": cloud(snap.path),
            "kf_positions": cloud(snap.kf_positions),
            "points_all": cloud(snap.points_all),
            "points_ref": cloud(snap.points_ref),
        }
        self.f.write(json.dumps(rec) + "\n")
        self.f.flush()

    def close(self) -> None:
        self.f.close()


def save_ply(path: str, points: np.ndarray) -> None:
    """Write a point cloud as ASCII PLY (one-shot export for external viewers)."""
    points = np.asarray(points, np.float64)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(points)}\n"
            "property float x\nproperty float y\nproperty float z\nend_header\n"
        )
        for p in points:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")


def _camera_centers(poses_cw: np.ndarray) -> np.ndarray:
    """Camera centers C = -R^T t from (N,4,4) Tcw poses."""
    if len(poses_cw) == 0:
        return np.zeros((0, 3), np.float32)
    R = poses_cw[:, :3, :3]
    t = poses_cw[:, :3, 3]
    return -np.einsum("nij,ni->nj", R, t)


class MapPublisher:
    """Polls the live tracker + arena and fans snapshots out to sinks.

    The reference spawns two threads (path + clouds, ros_publisher.cpp:18-26)
    polling at ~1 kHz; one thread at a sane default rate publishes both here —
    the split served ROS topic granularity, not throughput."""

    def __init__(
        self,
        tracker,
        arena,
        sinks: Optional[Sequence] = None,
        rate_hz: float = 10.0,
        remap_axes: bool = True,
    ):
        self.tracker = tracker
        self.arena = arena
        self.sinks: List = list(sinks) if sinks else [MemorySink()]
        self.rate_hz = rate_hz
        self.remap_axes = remap_axes
        self.seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -------------------------------------------------------------- snapshotting

    def snapshot(self) -> Snapshot:
        """Assemble one Snapshot from current (unlocked, viz-grade) state."""
        arena = self.arena
        # path: live reconstruction from per-frame relative poses against the
        # CURRENT keyframe estimates — same composition as the reference's
        # GetCameraTrajectory (ros_publisher.cpp:67-122)
        records = list(self.tracker.records)  # snapshot the list object itself
        path_poses = []
        prev = np.eye(4, dtype=np.float32)
        for r in records:
            if r.pose is not None:
                if r.rel_pose is not None and r.ref_kf >= 0:
                    Trw = arena.kf_pose[r.ref_kf].astype(np.float64)
                    prev = (r.rel_pose @ Trw).astype(np.float32)
                else:
                    prev = r.pose
            path_poses.append(prev)
        path = _camera_centers(np.asarray(path_poses).reshape(-1, 4, 4))

        kf_mask = arena.kf_valid[: arena.num_kfs]
        kf_positions = _camera_centers(arena.kf_pose[: arena.num_kfs][kf_mask])

        pt_mask = arena.pt_valid[: arena.num_pts]
        points_all = arena.pt_pos[: arena.num_pts][pt_mask].astype(np.float32)

        # reference cloud: the points in the tracker's current local tracking
        # block (Map::GetReferenceMapPoints carries the tracker's local map)
        block_ids = getattr(self.tracker, "_block_ids", None)
        if block_ids is not None and len(block_ids):
            ids = np.asarray(block_ids)
            ids = ids[(ids >= 0) & (ids < arena.num_pts)]
            ids = ids[arena.pt_valid[ids]]
            points_ref = arena.pt_pos[ids].astype(np.float32)
        else:
            points_ref = np.zeros((0, 3), np.float32)

        if self.remap_axes:
            path = axis_remap(path)
            kf_positions = axis_remap(kf_positions)
            points_all = axis_remap(points_all)
            points_ref = axis_remap(points_ref)

        snap = Snapshot(
            seq=self.seq,
            wall_time=time.time(),
            n_frames=len(records),
            n_keyframes=int(kf_mask.sum()),
            n_points=int(pt_mask.sum()),
            path=path,
            kf_positions=kf_positions,
            points_all=points_all,
            points_ref=points_ref,
        )
        self.seq += 1
        return snap

    def publish_once(self) -> Snapshot:
        snap = self.snapshot()
        for s in self.sinks:
            s.publish(snap)
        return snap

    # -------------------------------------------------------------- thread loop

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True, name="map-publisher")
        self._thread.start()

    def _run(self) -> None:
        period = 1.0 / max(self.rate_hz, 1e-3)
        while not self._stop.wait(period):
            try:
                self.publish_once()
            except Exception:
                # the map mutates under us (by design, like the reference's
                # unlocked 1 kHz polls); a torn read is retried next tick
                continue

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        for s in self.sinks:
            s.close()
