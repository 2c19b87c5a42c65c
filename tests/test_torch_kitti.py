"""The port's KITTI loader (slam_framework_torch/io/kitti.py) and runners
(slam_framework_torch/examples/main_*.py) against the reference's, on a 20-frame
synthetic sequence written in KITTI odometry layout (the scenario of
tests/test_kitti_io.py).

Tolerances: the loader's images, timestamps and ground truth equal the
reference loader's exactly; both packages' `main_stereo` track all 20 frames and
their ATE agree within 1 cm, both below 0.09 m (the bound of the mapper slice in
tests/test_torch_slice.py). The monocular and RGB-D runners are in
tests/test_torch_runners.py.
"""

import json
import os
import shutil
import sys

import cv2
import numpy as np
import pytest
import torch

from slam_framework_tpu.io import kitti as jkitti
from slam_framework_torch import config as tconf
from slam_framework_torch.examples import main_stereo
from slam_framework_torch.io import kitti, synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    """A 20-frame synthetic sequence in KITTI odometry layout + ground truth."""
    root = tmp_path_factory.mktemp("kitti")
    seq_dir = root / "sequences" / "03"
    cam = tconf.CameraConfig(fx=400.0, fy=400.0, cx=320.0, cy=120.0, width=640, height=240, bf=200.0)
    world = synthetic.make_world(num_frames=20, cam=cam, seed=5, speed=0.8, num_landmarks=3000)
    (seq_dir / "image_2").mkdir(parents=True)
    (seq_dir / "image_3").mkdir(parents=True)
    for f in range(20):
        l, r = world.stereo_pair(f)
        cv2.imwrite(str(seq_dir / "image_2" / f"{f:06d}.png"), l)
        cv2.imwrite(str(seq_dir / "image_3" / f"{f:06d}.png"), r)
    np.savetxt(seq_dir / "times.txt", world.timestamps)
    gt_dir = root / "ground_truth_poses" / "poses"
    gt_dir.mkdir(parents=True)
    rows = np.stack([np.linalg.inv(T)[:3, :].reshape(-1) for T in world.poses])
    np.savetxt(gt_dir / "03.txt", rows)
    cfg_path = root / "config.json"
    cfg_path.write_text(json.dumps({
        "camera": {"fx": 400.0, "fy": 400.0, "cx": 320.0, "cy": 120.0,
                   "width": 640, "height": 240, "bf": 200.0, "fps": 10.0},
        "orb_parameters": {"num_features": 600, "scale_factor": 1.2, "num_levels": 4},
    }))
    return {"root": str(root), "seq": str(seq_dir), "cfg": str(cfg_path), "world": world}


def test_load_sequence(kitti_dir):
    seq = kitti.load_sequence(kitti_dir["seq"])
    ref = jkitti.load_sequence(kitti_dir["seq"])
    assert len(seq) == 20 == len(ref)
    l, r = seq.stereo_pair(0)
    assert l.shape == (240, 640) and r.shape == (240, 640)
    assert l.dtype == np.uint8
    assert np.all(np.diff(seq.timestamps) > 0)
    np.testing.assert_array_equal(seq.timestamps, ref.timestamps)
    for f in (0, 7, 19):
        for a, b in zip(seq.stereo_pair(f), ref.stereo_pair(f)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(seq.mono(f), kitti_dir["world"].render(f))
    frames = list(seq.frames())
    assert [f for f, *_ in frames] == list(range(20))


def test_load_ground_truth(kitti_dir):
    gt = kitti.load_ground_truth(kitti_dir["root"], "03")
    assert gt is not None and gt.shape == (20, 4, 4)
    np.testing.assert_allclose(gt[0], np.eye(4), atol=1e-6)
    np.testing.assert_array_equal(gt, jkitti.load_ground_truth(kitti_dir["root"], "03"))
    assert kitti.load_ground_truth(kitti_dir["root"], "99") is None


def test_plain_kitti_layout_grey_fallback_and_mono_only(kitti_dir, tmp_path):
    """poses/<seq>.txt beside the sequences, image_0/image_1 when image_2 is
    absent, and a left-only sequence whose right images are the left ones."""
    os.makedirs(tmp_path / "poses")
    shutil.copy(os.path.join(kitti_dir["root"], "ground_truth_poses", "poses", "03.txt"), tmp_path / "poses" / "03.txt")
    np.testing.assert_array_equal(kitti.load_ground_truth(str(tmp_path), "03"),
                                  kitti.load_ground_truth(kitti_dir["root"], "03"))
    grey = tmp_path / "grey"
    shutil.copytree(os.path.join(kitti_dir["seq"], "image_2"), grey / "image_0")
    shutil.copytree(os.path.join(kitti_dir["seq"], "image_3"), grey / "image_1")
    shutil.copy(os.path.join(kitti_dir["seq"], "times.txt"), grey / "times.txt")
    seq = kitti.load_sequence(str(grey))
    assert seq.left_paths[0].endswith(os.path.join("image_0", "000000.png"))
    np.testing.assert_array_equal(seq.stereo_pair(3)[1], kitti.load_sequence(kitti_dir["seq"]).stereo_pair(3)[1])
    shutil.rmtree(grey / "image_1")
    mono = kitti.load_sequence(str(grey))
    assert mono.right_paths == mono.left_paths
    ref = jkitti.load_sequence(str(grey))
    assert [os.path.basename(p) for p in ref.right_paths] == [os.path.basename(p) for p in mono.right_paths]


def test_missing_sequence_raises(tmp_path):
    with pytest.raises((FileNotFoundError, OSError)):
        kitti.load_sequence(str(tmp_path / "nope"))
    os.makedirs(tmp_path / "short" / "image_2")
    np.savetxt(tmp_path / "short" / "times.txt", np.arange(3) * 0.1)
    with pytest.raises(FileNotFoundError):
        kitti.load_sequence(str(tmp_path / "short"))


def test_main_stereo_matches_reference_runner(kitti_dir, tmp_path, capsys):
    """Both packages' stereo runner over the same 20 files: frames, trajectory
    file and ATE (port on the CPU)."""
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import main_stereo as jmain_stereo
    finally:
        sys.path.pop(0)
    reports = {}
    for name, run in (("ref", jmain_stereo.run), ("port", main_stereo.run)):
        out = str(tmp_path / f"{name}.txt")
        argv = [kitti_dir["cfg"], kitti_dir["seq"], "--out", out, "--gt-root", kitti_dir["root"], "--seq", "03"]
        assert run(argv + (["--device", "cpu"] if name == "port" else [])) == 0
        reports[name] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert np.loadtxt(out).shape == (20, 12)
    ref, port = reports["ref"], reports["port"]
    assert set(port) == set(ref)
    assert port["frames"] == ref["frames"] == 20
    assert port["keyframes"] >= 2
    assert abs(port["ate_rmse_m"] - ref["ate_rmse_m"]) < 0.01, (port, ref)
    assert max(port["ate_rmse_m"], ref["ate_rmse_m"]) < 0.09, (port, ref)
