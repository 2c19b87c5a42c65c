"""The port's monocular and RGB-D runners (slam_framework_torch/examples/main_mono.py,
main_rgbd.py) end to end on the CPU, and the rule that every runner needs a CUDA
device unless the CPU is asked for.

The monocular runner reads a few frames of a KITTI-layout sequence written with
cv2; the RGB-D runner runs `--synthetic` and a TUM-style directory (8-bit colour
and 16-bit depth PNGs written with cv2, read by io/png). Tolerances: the TUM
loader's grey image equals the rendered one exactly and its depth the written
millimetres / 1000 exactly (within 1 mm of the ray-cast depth where that is
below 65 m); the synthetic run's ATE below 0.09 m (the mapper slice's bound,
tests/test_torch_slice.py).
"""

import json

import cv2
import numpy as np
import pytest
import torch

from slam_framework_torch import config as tconf
from slam_framework_torch.examples import main_mono, main_rgbd, main_stereo
from slam_framework_torch.io import synthetic

CAM = dict(fx=400.0, fy=400.0, cx=320.0, cy=120.0, width=640, height=240, bf=200.0)
ORB = {"num_features": 600, "scale_factor": 1.2, "num_levels": 4}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; torch's default of one
    thread per core in each of them oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    """A short synthetic sequence in KITTI odometry layout + ground truth."""
    root = tmp_path_factory.mktemp("kitti")
    seq_dir = root / "sequences" / "03"
    world = synthetic.make_world(num_frames=6, cam=tconf.CameraConfig(**CAM), seed=5, speed=0.8,
                                 num_landmarks=3000)
    (seq_dir / "image_2").mkdir(parents=True)
    (seq_dir / "image_3").mkdir(parents=True)
    for f in range(world.num_frames):
        l, r = world.stereo_pair(f)
        cv2.imwrite(str(seq_dir / "image_2" / f"{f:06d}.png"), l)
        cv2.imwrite(str(seq_dir / "image_3" / f"{f:06d}.png"), r)
    np.savetxt(seq_dir / "times.txt", world.timestamps)
    gt_dir = root / "ground_truth_poses" / "poses"
    gt_dir.mkdir(parents=True)
    np.savetxt(gt_dir / "03.txt", np.stack([np.linalg.inv(T)[:3, :].reshape(-1) for T in world.poses]))
    cfg_path = root / "config.json"
    cfg_path.write_text(json.dumps({"camera": {**CAM, "fps": 10.0}, "orb_parameters": ORB}))
    return {"root": str(root), "seq": str(seq_dir), "cfg": str(cfg_path)}


def test_main_mono_runs_on_the_port(kitti_dir, tmp_path, capsys):
    out = str(tmp_path / "kf.txt")
    assert main_mono.run([kitti_dir["cfg"], kitti_dir["seq"], "--out", out, "--max-frames", "5",
                          "--gt-root", kitti_dir["root"], "--seq", "03", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["frames"] == 5
    assert set(report) == {"frames", "keyframes", "map_points", "loops_closed", "fps", "trajectory",
                           "ate_rmse_sim3_m"}


def _millimetres(depth_m: np.ndarray) -> np.ndarray:
    """A depth map in metres as a 16-bit PNG's samples in millimetres (0 = no depth)."""
    mm = np.rint(depth_m * 1000.0)
    return np.where(mm <= 65535, mm, 0).astype(np.uint16)


def test_main_rgbd_synthetic_and_tum_directory(tmp_path, capsys):
    """`--synthetic` on the port, and a TUM-style directory (8-bit colour, 16-bit
    depth PNGs in millimetres, depth_map_factor 1000) read without cv2."""
    assert main_rgbd.run(["--synthetic", "6", "--out", str(tmp_path / "syn.txt"), "--device", "cpu"]) == 0
    syn = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert syn["frames"] == 6 and syn["ate_rmse_m"] < 0.09, syn

    world = synthetic.make_world(num_frames=4, cam=tconf.CameraConfig(**CAM), seed=1, speed=0.8, yaw_rate=0.004)
    tum = tmp_path / "tum"
    (tum / "rgb").mkdir(parents=True)
    (tum / "depth").mkdir()
    for f in range(world.num_frames):
        gray, depth = world.rgbd_pair(f)
        cv2.imwrite(str(tum / "rgb" / f"{f:04d}.png"), np.dstack([gray] * 3))
        cv2.imwrite(str(tum / "depth" / f"{f:04d}.png"), _millimetres(depth))
    frames = list(main_rgbd._load_tum_dir(str(tum), 1000.0))
    assert len(frames) == 4
    gray0, depth0, _ = frames[0]
    want_gray, want_depth = world.rgbd_pair(0)
    np.testing.assert_array_equal(gray0, want_gray)
    np.testing.assert_array_equal(depth0, _millimetres(want_depth).astype(np.float32) / np.float32(1000.0))
    near = (want_depth > 0) & (want_depth < 65.0)
    assert np.abs(depth0 - want_depth)[near].max() < 1e-3
    cfg_path = tmp_path / "rgbd.json"
    cfg_path.write_text(json.dumps({"camera": {**CAM, "fps": 10.0, "depth_map_factor": 1000.0},
                                    "orb_parameters": ORB}))
    assert main_rgbd.run([str(cfg_path), str(tum), "--out", str(tmp_path / "t.txt"), "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["frames"] == 4


def test_runners_need_cuda_unless_the_cpu_is_asked_for(kitti_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run, argv in ((main_stereo.run, [kitti_dir["cfg"], kitti_dir["seq"]]),
                      (main_mono.run, [kitti_dir["cfg"], kitti_dir["seq"]]),
                      (main_rgbd.run, ["--synthetic", "2"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(argv)
