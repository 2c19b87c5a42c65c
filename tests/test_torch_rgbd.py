"""The port's RGB-D sensor against the reference (io/synthetic.rgbd_pair,
pipeline/frame.RgbdFrontend, SlamSystem.track_rgbd) at 640x240 with 800
features on 4 levels, the same (port-rendered) pixels through both packages.

Tolerances, with their reasons:
  - rgbd_pair: the reference's ray cast over the port world's textures (the two
    packages make their textures with different rasterisers, so the textures
    are shared): gray bit-equal, depth within 1e-5 relative; the gray image is
    the left image of `stereo_pair` (one ray cast gives both);
  - RgbdFrontend: keypoints, octaves and validity equal; depth sampled at the
    same rounded pixels, so depth and u_right within 1e-4 and the same features
    have them;
  - the system test of tests/test_system.py (TestSystemRgbd, 16 frames) in the
    port: the reference test's own bound (ATE < 0.08 m), and against the
    reference's poses on the same pixels the tolerances of test_torch_slice.py
    (median camera-centre gap < 0.01 m, |ATE difference| < 0.01 m).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_framework_tpu.config import CameraConfig as JCam, CapacityConfig as JCap, OrbConfig as JOrb
from slam_framework_tpu.config import SlamConfig as JCfg
from slam_framework_tpu.io import synthetic as jsyn
from slam_framework_tpu.io import trajectory as jtraj
from slam_framework_tpu.pipeline.frame import RgbdFrontend as JRgbd
from slam_framework_tpu.system import SlamSystem as JSystem
from slam_framework_torch import config as tconf
from slam_framework_torch.io import synthetic as tsyn, trajectory
from slam_framework_torch.pipeline.frame import RgbdFrontend as TRgbd
from slam_framework_torch.system import SlamSystem


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; torch's default of one
    thread per core in each of them oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CAM = dict(fx=400.0, fy=400.0, cx=320.0, cy=120.0, width=640, height=240, fps=10.0, bf=400.0 * 0.54)
CAP = dict(max_keyframes=64, max_map_points=65536, max_features=1024, local_window_points=8192)
# tests/test_system.py's world
WORLD = dict(num_frames=30, seed=1, speed=0.8, yaw_rate=0.004, num_landmarks=2500)
N_FRAMES = 16


def _jcfg():
    return JCfg(camera=JCam(**CAM), orb=JOrb(num_features=800, num_levels=4), capacity=JCap(**CAP), sensor="rgbd")


def _tcfg():
    return tconf.SlamConfig(camera=tconf.CameraConfig(**CAM), orb=tconf.OrbConfig(num_features=800, num_levels=4),
                            capacity=tconf.CapacityConfig(**CAP), sensor="rgbd")


@pytest.fixture(scope="module")
def world():
    return tsyn.make_world(cam=_tcfg().camera, **WORLD)


def test_rgbd_pair_matches_the_reference_ray_cast(world):
    jw = jsyn.make_world(cam=_jcfg().camera, **WORLD)
    jw.surfaces = [jsyn._Surface(**dataclasses.asdict(s)) for s in world.surfaces]
    for f in (0, 7, 29):
        want_g, want_d = jw.rgbd_pair(f)
        gray, depth = world.rgbd_pair(f)
        assert gray.dtype == np.uint8 and depth.dtype == np.float32
        np.testing.assert_array_equal(gray, want_g)
        np.testing.assert_allclose(depth, want_d, rtol=1e-5, atol=0)
        np.testing.assert_array_equal(gray, world.render(f))
        np.testing.assert_array_equal(depth, world.render_depth(f))
        assert (depth > 0).mean() > 0.5


def test_rgbd_frontend_matches_reference(world):
    gray, depth = world.rgbd_pair(7)
    g32 = gray.astype(np.float32)
    want = JRgbd(_jcfg())(jnp.asarray(g32), jnp.asarray(depth))
    got = TRgbd(_tcfg())(torch.from_numpy(g32), torch.from_numpy(depth))
    for name in ("xy", "octave", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    ur, d = got.u_right.numpy(), got.depth.numpy()
    np.testing.assert_array_equal(ur > -1.0, np.asarray(want.u_right) > -1.0)
    np.testing.assert_array_equal(d > 0, np.asarray(want.depth) > 0)
    np.testing.assert_allclose(ur, np.asarray(want.u_right), rtol=0, atol=1e-4)
    np.testing.assert_allclose(d, np.asarray(want.depth), rtol=1e-4, atol=1e-4)
    assert (d > 0).sum() > 500
    # depth comes from the rounded raw pixel of each valid feature (0 = no depth)
    v = got.valid.numpy()
    xy = got.xy.numpy()[v]
    ui = np.clip(np.round(xy[:, 0]).astype(int), 0, 639)
    vi = np.clip(np.round(xy[:, 1]).astype(int), 0, 239)
    sampled = depth[vi, ui]
    np.testing.assert_allclose(d[v], np.where(sampled > 0, sampled, -1.0), rtol=1e-6)
    # a raw depth map in sensor units is divided by camera.depth_map_factor
    tcfg = _tcfg()
    raw = dataclasses.replace(tcfg, camera=dataclasses.replace(tcfg.camera, depth_map_factor=5000.0))
    scaled = TRgbd(raw)(torch.from_numpy(g32), torch.from_numpy(depth * np.float32(5000.0)))
    np.testing.assert_allclose(scaled.depth.numpy(), d, rtol=1e-6)
    np.testing.assert_allclose(scaled.u_right.numpy(), ur, rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def runs(world):
    frames = [world.rgbd_pair(f) for f in range(N_FRAMES)]
    system = SlamSystem(_tcfg(), device=torch.device("cpu"))
    for f in range(N_FRAMES):
        system.track_rgbd(*frames[f], world.timestamps[f])
    stats = system.shutdown()
    jsys = JSystem(_jcfg())
    for f in range(N_FRAMES):
        jsys.track_rgbd(*frames[f], world.timestamps[f])
    jstats = jsys.shutdown()
    return dict(system=system, stats=stats, jsys=jsys, jstats=jstats)


def _centers(poses):
    return np.stack([np.linalg.inv(T.astype(np.float64))[:3, 3] for T in poses])


def test_system_rgbd_end_to_end(world, runs):
    """TestSystemRgbd.test_end_to_end (tests/test_system.py:86-97) in the port."""
    stats = runs["stats"]
    assert stats["keyframes"] >= 1 and stats["resets"] == 0
    est = runs["system"].frame_poses()
    assert est.shape == (N_FRAMES, 4, 4)
    ate = trajectory.ate_rmse(est, world.poses[: len(est)], align="se3")
    assert ate < 0.08, f"RGBD ATE {ate:.3f} m"


def test_system_rgbd_follows_the_reference(world, runs):
    est = runs["system"].frame_poses()
    ref = runs["jsys"].frame_poses()
    assert len(est) == len(ref) == N_FRAMES
    assert not any(r.lost for r in runs["system"].tracker.records)
    gap = np.linalg.norm(_centers(est) - _centers(ref), axis=1)
    assert np.median(gap) < 0.01, gap
    ate = trajectory.ate_rmse(est, world.poses[:N_FRAMES], align="se3")
    jate = jtraj.ate_rmse(ref, world.poses[:N_FRAMES], align="se3")
    assert abs(ate - jate) < 0.01, (ate, jate)
    # RGB-D keyframes spawn depth points, as stereo ones do
    arena = runs["system"].arena
    assert arena.n_valid_pts > 200
    assert (arena.kf_depth[0][arena.kf_feat_valid[0]] > 0).mean() > 0.5


def test_track_device_takes_a_float32_gray_depth_pair(world):
    system = SlamSystem(_tcfg(), device="cpu", place_recognition=False)
    gray, depth = world.rgbd_pair(0)
    with pytest.raises(ValueError, match="float32"):
        system.tracker.track_device(torch.from_numpy(np.stack([gray, gray])), 0.0)
    with pytest.raises(ValueError, match="a stereo entry point on a rgbd system"):
        system.track_stereo(gray, gray, 0.0)
    frame = torch.from_numpy(np.stack([gray.astype(np.float32), depth]))
    assert system.tracker.track_device(frame, 0.0) is not None  # initialised from one frame
    assert system.arena.n_valid_kfs == 1 and system.arena.n_valid_pts > 200
