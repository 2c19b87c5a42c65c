"""The port's live map publisher (slam_framework_torch/viz) against the
reference's (slam_framework_tpu/viz, tests/test_viz.py).

The reference tracker runs 12 frames once; its arena is copied into the port's
(`interop.arena`) and both publishers snapshot the same map and the same frame
records. Tolerance: none — the snapshot is host numpy arithmetic copied from
the reference, so every array equals the reference's. The cases of
tests/test_viz.py then run on the port's publisher, and `SlamSystem(use_viewer=
True)` starts the thread, publishes from the port's own tracker, restarts it on
a reset and stops it on shutdown.
"""

import dataclasses
import json
import time
import types

import numpy as np
import pytest
import torch

from slam_framework_tpu.config import CameraConfig, CapacityConfig, OrbConfig, SlamConfig
from slam_framework_tpu.io import synthetic as jsynthetic
from slam_framework_tpu.pipeline.tracker import StereoTracker
from slam_framework_tpu.viz import MapPublisher as JPublisher
from slam_framework_torch import config as tconf, interop
from slam_framework_torch.io import synthetic
from slam_framework_torch.system import SlamSystem
from slam_framework_torch.viz import CallbackSink, JsonlSink, MapPublisher, MemorySink, axis_remap, save_ply


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; torch's default of one
    thread per core in each of them oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CAM = dict(fx=400.0, fy=400.0, cx=320.0, cy=120.0, width=640, height=240, bf=160.0)
CAP = dict(max_features=600, max_keyframes=64, max_map_points=16384, local_window_points=4096,
           ba_points=1024, ba_obs=4096)


@pytest.fixture(scope="module")
def reference():
    """The reference tracker after 12 frames (tests/test_viz.py's `tracked`)."""
    cfg = SlamConfig(camera=CameraConfig(**CAM), orb=OrbConfig(num_features=600, num_levels=4),
                     capacity=CapacityConfig(**CAP))
    world = jsynthetic.make_world(num_frames=12, cam=cfg.camera, seed=2, speed=0.8, num_landmarks=2000)
    tracker = StereoTracker(cfg)
    for f in range(world.num_frames):
        tracker.track(*world.stereo_pair(f), world.timestamps[f])
    tracker.flush()
    return tracker


@pytest.fixture(scope="module")
def tracked(reference):
    """The port's view of the same run: the copied arena, the same records and block."""
    arena = interop.arena(reference.arena)
    return types.SimpleNamespace(arena=arena, records=list(reference.records),
                                 _block_ids=np.asarray(reference._block_ids))


@pytest.mark.parametrize("remap", [False, True])
def test_snapshot_equals_reference_publisher(reference, tracked, remap):
    want = JPublisher(reference, reference.arena, remap_axes=remap).snapshot()
    got = MapPublisher(tracked, tracked.arena, remap_axes=remap).snapshot()
    for f in ("seq", "n_frames", "n_keyframes", "n_points"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("path", "kf_positions", "points_all", "points_ref"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.n_keyframes >= 2 and len(got.points_ref) > 0


def test_axis_remap_matches_reference_convention():
    # (x,y,z) -> (z,-x,-y), ros_publisher.cpp:110-117
    p = np.array([[1.0, 2.0, 3.0]])
    np.testing.assert_allclose(axis_remap(p), [[3.0, -1.0, -2.0]])
    # a period-3 rotation: applying it thrice returns the original
    np.testing.assert_allclose(axis_remap(axis_remap(axis_remap(p))), p)


def test_snapshot_contents(tracked):
    pub = MapPublisher(tracked, tracked.arena, sinks=[MemorySink()], remap_axes=False)
    snap = pub.publish_once()
    assert snap.n_frames == len(tracked.records)
    assert snap.n_keyframes == tracked.arena.n_valid_kfs
    assert snap.n_points == tracked.arena.n_valid_pts
    assert snap.path.shape == (snap.n_frames, 3)
    assert snap.points_all.shape == (snap.n_points, 3)
    assert snap.kf_positions.shape == (snap.n_keyframes, 3)
    # the forward corridor: the camera travels along +z in camera convention
    assert snap.path[-1, 2] > snap.path[0, 2]
    # the reference cloud is a subset of the local tracking block
    assert 0 < len(snap.points_ref) <= snap.n_points


def test_snapshot_remap(tracked):
    raw = MapPublisher(tracked, tracked.arena, remap_axes=False).snapshot()
    rem = MapPublisher(tracked, tracked.arena, remap_axes=True).snapshot()
    np.testing.assert_allclose(rem.path, axis_remap(raw.path), atol=1e-6)
    np.testing.assert_allclose(rem.points_all, axis_remap(raw.points_all), atol=1e-6)


def test_background_thread_publishes(tracked):
    sink = MemorySink()
    seen = []
    pub = MapPublisher(tracked, tracked.arena, sinks=[sink, CallbackSink(seen.append)], rate_hz=100.0)
    pub.start()
    t0 = time.time()
    while len(sink.snapshots) < 3 and time.time() - t0 < 5.0:
        time.sleep(0.01)
    pub.stop()
    assert pub._thread is None
    assert len(sink.snapshots) >= 3
    seqs = [s.seq for s in sink.snapshots]
    assert seqs == sorted(seqs)
    assert [s.seq for s in seen][: len(seqs)] == seqs[: len(seen)]


def test_jsonl_sink_round_trips(tracked, tmp_path):
    path = str(tmp_path / "viz.jsonl")
    pub = MapPublisher(tracked, tracked.arena, sinks=[JsonlSink(path, max_points=100)])
    pub.publish_once()
    pub.publish_once()
    pub.stop()
    lines = open(path).read().strip().splitlines()
    assert len(lines) == 2
    rec = json.loads(lines[0])
    assert rec["n_keyframes"] == tracked.arena.n_valid_kfs
    assert len(rec["points_all"]) <= 100
    assert len(rec["path"]) == len(tracked.records)


def test_save_ply(tracked, tmp_path):
    path = str(tmp_path / "cloud.ply")
    pts = tracked.arena.pt_pos[: tracked.arena.num_pts][tracked.arena.pt_valid[: tracked.arena.num_pts]]
    save_ply(path, pts)
    txt = open(path).read().splitlines()
    assert txt[0] == "ply"
    assert f"element vertex {len(pts)}" in txt[2]
    assert len(txt) == 7 + len(pts)


def test_system_facade_starts_publisher():
    cfg = tconf.SlamConfig(camera=tconf.CameraConfig(**CAM), orb=tconf.OrbConfig(num_features=600, num_levels=4),
                           capacity=tconf.CapacityConfig(**CAP), use_viewer=True)
    world = synthetic.make_world(num_frames=8, cam=cfg.camera, seed=2, speed=0.8, num_landmarks=2000)
    sys_ = SlamSystem(cfg, device="cpu", place_recognition=False)
    assert sys_.publisher is not None and sys_.publisher._thread.is_alive()
    first = sys_.publisher
    sys_.reset()   # a reset stops the old publisher and starts one on the new map
    assert first._thread is None and sys_.publisher is not first and sys_.publisher._thread.is_alive()
    for f in range(world.num_frames):
        sys_.track_stereo(*world.stereo_pair(f), world.timestamps[f])
    sys_.tracker.flush()
    snap = sys_.publisher.publish_once()
    assert snap.n_keyframes >= 1 and snap.n_keyframes == sys_.arena.n_valid_kfs
    assert snap.n_frames == len(sys_.tracker.records) == world.num_frames
    sys_.shutdown()
    assert sys_.publisher._thread is None
    off = SlamSystem(dataclasses.replace(cfg, use_viewer=False), device="cpu", place_recognition=False)
    assert off.publisher is None
