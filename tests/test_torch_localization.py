"""Localization mode's local block, the port against the reference, on one map.

The reference `SlamSystem` maps 30 frames of the world of tests/test_system.py
(with the cut block below, so that its compiled programs serve the second run)
and saves its map; the reference and the port each load that file, go into
localization mode and track the same 30 frames again from the start. The local
block is cut to the reference keyframe and its best covisible keyframe
(`local_map_kf_cap=2`), so a block that is not rebuilt goes stale within these
frames.

The reference rebuilds its block only at keyframes, and localization mode makes
none: its reference keyframe stays the one it relocalized against. The port lets
the reference keyframe follow the camera (the keyframe observing most of the
frame's tracked points) and rebuilds the block around it
(`StereoTracker._follow_reference_keyframe`). Outcome, pinned here: neither
package loses a frame, and the reference's stale block costs it accuracy; with
the following switched off, the port tracks as the reference does. Tolerances:
the port's ATE below 0.6 times the reference's (0.48 when this was written) and
both below 0.2 m; with the
following off, the port's ATE within 1 cm of the reference's (the slice tests'
bound, tests/test_torch_slice.py) and its reference keyframe never moves.
"""

import dataclasses

import numpy as np
import pytest
import torch

from slam_framework_tpu.config import CameraConfig, CapacityConfig, OrbConfig, SlamConfig, TrackerConfig
from slam_framework_tpu.system import SlamSystem as JSlamSystem
from slam_framework_torch import config as tconf
from slam_framework_torch.io import synthetic, trajectory
from slam_framework_torch.pipeline.tracker import StereoTracker
from slam_framework_torch.system import SlamSystem as TSlamSystem

N = 30


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; torch's default of one
    thread per core in each of them oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jcfg(kf_cap: int):
    return SlamConfig(
        camera=CameraConfig(fx=400.0, fy=400.0, cx=320.0, cy=120.0, width=640, height=240, fps=10.0, bf=400.0 * 0.54),
        orb=OrbConfig(num_features=800, num_levels=4),
        capacity=CapacityConfig(max_keyframes=64, max_map_points=65536, max_features=1024, local_window_points=8192),
        tracker=dataclasses.replace(TrackerConfig(), local_map_kf_cap=kf_cap),
    )


def _tcfg(kf_cap: int):
    j = _jcfg(kf_cap)
    return tconf.SlamConfig(camera=tconf.CameraConfig(**dataclasses.asdict(j.camera)),
                            orb=tconf.OrbConfig(**dataclasses.asdict(j.orb)),
                            capacity=tconf.CapacityConfig(**dataclasses.asdict(j.capacity)),
                            tracker=tconf.TrackerConfig(**dataclasses.asdict(j.tracker)))


@pytest.fixture(scope="module")
def world():
    return synthetic.make_world(num_frames=N, cam=_tcfg(2).camera, seed=1, speed=0.8, yaw_rate=0.004,
                                num_landmarks=2500)


@pytest.fixture(scope="module")
def saved_map(world, tmp_path_factory):
    """The reference system's map of the N frames, saved to one file both packages read."""
    s = JSlamSystem(_jcfg(2))
    for f in range(N):
        s.track_stereo(*world.stereo_pair(f), world.timestamps[f])
    path = str(tmp_path_factory.mktemp("loc") / "map.npz")
    s.save_map(path)
    return path


def _localize(system, path, world):
    """Load the map, localization mode, the N frames again from frame 0; the new
    records' lost frames, ATE over the tracked ones and reference keyframes."""
    system.load_map(path)
    n_saved = len(system.tracker.records)
    kfs = system.arena.n_valid_kfs
    system.activate_localization_mode()
    for f in range(N):
        system.track_stereo(*world.stereo_pair(f), 0.1 * (N + f))
    system.tracker.flush()
    recs = system.tracker.records[n_saved:]
    ok = [i for i, r in enumerate(recs) if not r.lost]
    est = np.stack([recs[i].pose for i in ok])
    assert system.arena.n_valid_kfs == kfs
    return {"lost": [i for i, r in enumerate(recs) if r.lost],
            "ate": trajectory.ate_rmse(est, world.poses[ok], align="se3"),
            "ref_kfs": [r.ref_kf for r in recs]}


@pytest.fixture(scope="module")
def runs(saved_map, world):
    out = {"reference": _localize(JSlamSystem(_jcfg(2)), saved_map, world),
           "port": _localize(TSlamSystem(_tcfg(2), device="cpu"), saved_map, world)}
    follow = StereoTracker._follow_reference_keyframe
    StereoTracker._follow_reference_keyframe = lambda self, pack, block_ids: None
    try:
        out["port_without_following"] = _localize(TSlamSystem(_tcfg(2), device="cpu"), saved_map, world)
    finally:
        StereoTracker._follow_reference_keyframe = follow
    print({k: (v["lost"], round(float(v["ate"]), 4), sorted(set(v["ref_kfs"]))) for k, v in out.items()})
    return out


def test_both_packages_track_every_frame_on_the_shared_map(runs):
    for name, run in runs.items():
        assert run["lost"] == [], (name, run["lost"])


def test_the_port_follows_the_camera_and_the_reference_block_stays(runs):
    assert len(set(runs["reference"]["ref_kfs"])) == 1
    assert len(set(runs["port_without_following"]["ref_kfs"])) == 1
    assert len(set(runs["port"]["ref_kfs"])) >= 3
    assert runs["port"]["ref_kfs"] == sorted(runs["port"]["ref_kfs"])


def test_the_stale_block_costs_the_reference_accuracy(runs):
    ref, port = runs["reference"]["ate"], runs["port"]["ate"]
    assert port < 0.6 * ref and max(port, ref) < 0.2, (port, ref)


def test_without_following_the_port_tracks_as_the_reference(runs):
    ref, port = runs["reference"]["ate"], runs["port_without_following"]["ate"]
    assert abs(port - ref) < 0.01, (port, ref)
