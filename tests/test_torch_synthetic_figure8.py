"""The port's figure-eight world (`make_figure_eight_world`) against the
reference's, and the reference's two-loop system test run on the port.

Tolerances: poses, timestamps and every surface's geometry (kind, radius,
texture origin and span, wrap, band, centre, radial limits, texture shapes)
are identical, since both consume the same `default_rng(seed)` stream in the
same order; pixels differ by less than 0.5 grey levels in mean, the tolerance
of `make_world`'s parity test in tests/test_torch_frontend.py (OpenCV's stamp
rasterisation is emulated, not copied). The `slow` case is
tests/test_system.py's TestMultiLoop on the port with its own bars: at least
two loops closed more than 100 frames apart, at most 3 lost frames, ATE below
1.0 m.
"""

import numpy as np
import pytest
import torch

from slam_framework_tpu.config import CameraConfig as JCam
from slam_framework_tpu.io import synthetic as jsyn
from slam_framework_torch import config as tconf
from slam_framework_torch.io import synthetic, trajectory
from slam_framework_torch.system import SlamSystem
from slam_framework_torch.tools.track_bench_world import figure_eight_world, multi_loop_config

CAM = dict(fx=400.0, fy=400.0, cx=320.0, cy=120.0, width=640, height=240, fps=10.0, bf=400.0 * 0.54)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; torch's default of one
    thread per core in each of them oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds():
    kw = dict(seed=4, speed=1.0, lap_frames=200)
    return (jsyn.make_figure_eight_world(cam=JCam(**CAM), **kw),
            synthetic.make_figure_eight_world(cam=tconf.CameraConfig(**CAM), **kw))


def test_trajectory_is_the_reference_world(worlds):
    jw, tw = worlds
    assert tw.num_frames == jw.num_frames == 450
    np.testing.assert_array_equal(tw.poses, jw.poses)
    np.testing.assert_array_equal(tw.timestamps, jw.timestamps)
    np.testing.assert_array_equal(tw.center, jw.center)
    for f in ("r_inner", "r_outer", "ground_y", "wall_top"):
        assert getattr(tw, f) == getattr(jw, f), f


def test_surfaces_are_the_reference_surfaces(worlds):
    jw, tw = worlds
    assert len(tw.surfaces) == len(jw.surfaces) == 6
    for a, b in zip(jw.surfaces, tw.surfaces):
        for f in ("kind", "radius", "res", "az0", "wrap", "y_top", "y_bot", "center", "az_span", "r_lo", "r_hi"):
            assert getattr(b, f) == getattr(a, f), f
        assert [m.shape for m in b.mips] == [m.shape for m in a.mips]
    # both circuits' walls are opened around the crossing
    assert sum(1 for s in tw.surfaces if s.kind == "cyl" and s.az_span < 2 * np.pi) >= 2


def test_other_arguments_follow_the_reference(worlds):
    kw = dict(seed=9, speed=0.7, lap_frames=120, num_frames=37, corridor_half_width=5.0)
    jw = jsyn.make_figure_eight_world(cam=JCam(**CAM), **kw)
    tw = synthetic.make_figure_eight_world(cam=tconf.CameraConfig(**CAM), **kw)
    np.testing.assert_array_equal(tw.poses, jw.poses)
    assert [s.az_span for s in tw.surfaces] == [s.az_span for s in jw.surfaces]


@pytest.mark.parametrize("frame", [0, 130, 230, 330, 449])
def test_pixels_match_reference_world(worlds, frame):
    """Both sites of the crossing (0, 200/400), lap A (130), lap B (230, 330), the end."""
    jw, tw = worlds
    for a, b in zip(jw.stereo_pair(frame), tw.stereo_pair(frame)):
        assert a.shape == b.shape == (240, 640) and b.dtype == np.uint8
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).mean() < 0.5


@pytest.mark.slow
def test_figure_eight_closes_two_loops():
    """tests/test_system.py::TestMultiLoop::test_figure_eight_closes_two_loops on the
    port (CPU), at its configuration (`multi_loop_config`, as chip_smoke.py's
    phase 11 runs it): a loop at each revisit of the crossing, ~lap_frames apart."""
    cfg = multi_loop_config()
    world = figure_eight_world(cfg)
    system = SlamSystem(cfg, sync_every=2, device=torch.device("cpu"))
    loops_at = []
    for f in range(world.num_frames):
        system.track_stereo(*world.stereo_pair(f), world.timestamps[f])
        if system.loop_closer and system.loop_closer.n_loops_closed > len(loops_at):
            loops_at.append(f)
    stats = system.shutdown()
    lost = sum(1 for r in system.tracker.records if r.lost)
    est = system.frame_poses()
    gt = world.poses[[r.frame_id for r in system.tracker.records]]
    ate = trajectory.ate_rmse(est, gt, align="se3")
    print("loops at", loops_at, "lost", lost, "ATE", ate, "GBAs", system.loop_closer.gba_log, stats)
    assert stats["loops_closed"] >= 2, f"loops at {loops_at}: {stats}"
    assert loops_at[1] - loops_at[0] > 100, loops_at
    assert lost <= 3, f"{lost} lost frames"
    assert ate < 1.0, f"figure-eight ATE {ate:.3f} m"
