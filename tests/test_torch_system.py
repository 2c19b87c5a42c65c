"""The port's SlamSystem constructor against the reference's
(slam_framework_tpu/system.py:49-103): a config file and a sensor build the same
SlamConfig in both; the viewer starts its publisher thread (it was refused
before viz/ was ported; tests/test_torch_viz.py covers it); an unknown sensor
and a missing config are refused."""

import dataclasses
import os

import pytest
import torch

from slam_framework_tpu.system import SlamSystem as JSystem
from slam_framework_torch import config as tconf
from slam_framework_torch.pipeline.mono_tracker import MonoTracker
from slam_framework_torch.pipeline.tracker import StereoTracker
from slam_framework_torch.system import SlamSystem

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "config", "kitti_stereo.json")


@pytest.mark.parametrize("sensor", [None, "stereo", "rgbd", "monocular"])
def test_config_path_builds_the_reference_config(sensor):
    ref = JSystem(config_path=CONFIG, sensor=sensor)
    port = SlamSystem(config_path=CONFIG, sensor=sensor, device=torch.device("cpu"), place_recognition=False)
    assert dataclasses.asdict(port.cfg) == dataclasses.asdict(ref.cfg)
    assert port.cfg.sensor == (sensor or "stereo")
    assert type(port.tracker) is (MonoTracker if sensor == "monocular" else StereoTracker)


def test_viewer_unknown_sensor_and_missing_config_are_refused():
    """The viewer is no longer refused: `use_viewer=True` starts the publisher's
    thread and `shutdown` stops it. An unknown sensor, a missing config and a
    stereo config handed to MonoTracker are refused."""
    cfg = tconf.SlamConfig(capacity=tconf.CapacityConfig(max_keyframes=8, max_map_points=1024, max_features=256))
    viewer = SlamSystem(dataclasses.replace(cfg, use_viewer=True), device="cpu", place_recognition=False)
    assert viewer.publisher._thread.is_alive()
    viewer.shutdown()
    assert viewer.publisher._thread is None
    with pytest.raises(ValueError, match="sensor 'lidar'"):
        SlamSystem(cfg, sensor="lidar", device="cpu")
    with pytest.raises(ValueError, match="cfg or config_path"):
        SlamSystem(device="cpu")
    with pytest.raises(ValueError, match="monocular"):
        MonoTracker(cfg, device="cpu")
