"""The port's stereo tracking slice against the reference StereoTracker over 16
frames of the small world (640x240, 800 features, 4 levels, sync_every=4).

The reference's mapper (`LocalMapper.process_keyframe` / `note_new_points`) is
stubbed here, since the port has no mapper yet; both trackers see the same
(port-rendered) pixels. Tolerances: the same keyframe frame ids and no lost
frames; per-frame camera translation within 1 cm. Per-stage differences are
fp32 rounding (pyramid sums, pose-optimisation sums, a few BRIEF bits); over
16 frames they move the LM iterates by a few millimetres at most.
"""

import numpy as np
import pytest
import torch

from slam_framework_tpu.config import CameraConfig as JCam, CapacityConfig as JCap, OrbConfig as JOrb
from slam_framework_tpu.config import SlamConfig as JCfg
from slam_framework_tpu.pipeline.local_mapper import LocalMapper
from slam_framework_tpu.pipeline.tracker import StereoTracker as JTracker
from slam_framework_torch import config as tconf
from slam_framework_torch.io import synthetic, trajectory
from slam_framework_torch.system import SlamSystem

CAM = dict(fx=400.0, fy=400.0, cx=320.0, cy=120.0, width=640, height=240, fps=10.0, bf=400.0 * 0.54)
CAP = dict(max_keyframes=64, max_map_points=65536, max_features=1024, local_window_points=8192)
N = 16


@pytest.fixture(scope="module")
def runs():
    tcfg = tconf.SlamConfig(camera=tconf.CameraConfig(**CAM), orb=tconf.OrbConfig(num_features=800, num_levels=4),
                            capacity=tconf.CapacityConfig(**CAP))
    world = synthetic.make_world(num_frames=30, cam=tcfg.camera, seed=1, speed=0.8, yaw_rate=0.004)
    pairs = [world.stereo_pair(f) for f in range(N)]

    system = SlamSystem(tcfg, sync_every=4, device=torch.device("cpu"))
    for f in range(N):
        system.track_stereo(*pairs[f], world.timestamps[f])
    stats = system.shutdown()

    jcfg = JCfg(camera=JCam(**CAM), orb=JOrb(num_features=800, num_levels=4), capacity=JCap(**CAP))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(LocalMapper, "process_keyframe", lambda self, *a, **k: None)
        mp.setattr(LocalMapper, "note_new_points", lambda self, *a, **k: None)
        jt = JTracker(jcfg, sync_every=4)
        for f in range(N):
            jt.track(*pairs[f], world.timestamps[f])
        jt.flush()
    return dict(world=world, system=system, stats=stats, jt=jt)


def _centers(poses):
    return np.stack([np.linalg.inv(T.astype(np.float64))[:3, 3] for T in poses])


def test_same_keyframes_and_no_lost_frames(runs):
    tt, jt = runs["system"].tracker, runs["jt"]
    assert len(tt.records) == len(jt.records) == N
    assert not any(r.lost for r in tt.records) and not any(r.lost for r in jt.records)
    np.testing.assert_array_equal(tt.arena.kf_frame_id[: tt.arena.num_kfs], jt.arena.kf_frame_id[: jt.arena.num_kfs])
    assert tt.arena.num_kfs >= 2


def test_per_frame_translation_within_1cm(runs):
    got = _centers(runs["system"].frame_poses())
    want = _centers(runs["jt"].trajectory_poses())
    assert np.linalg.norm(got - want, axis=1).max() < 0.01


def test_trajectory_follows_ground_truth_and_exports(runs, tmp_path):
    system, world = runs["system"], runs["world"]
    est = system.frame_poses()
    assert trajectory.ate_rmse(est, world.poses[:N], align="se3") < 0.09
    path = tmp_path / "traj.txt"
    system.save_trajectory_kitti(str(path))
    Twc = trajectory.load_kitti(str(path))
    np.testing.assert_allclose(Twc[:, :3, 3], _centers(est), atol=1e-5)
    assert runs["stats"] == {"frames": N, "keyframes": system.arena.n_valid_kfs,
                             "map_points": system.arena.n_valid_pts, "resets": 0}
