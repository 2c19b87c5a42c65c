"""The plain reference against the port's plain versions, on the CPU."""

import numpy as np
import pytest
import torch

from slambench import reference


@pytest.mark.parametrize("seed", [0, 1])
def test_fast_nms_equals_the_ports_plain_version(seed):
    from slam_framework_torch.ops import fast

    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (61, 83)).astype(np.float32)
    smooth = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / np.float32(3.0)  # non-integer levels too
    for x in (img, smooth):
        want = fast.nms3x3(fast.fast_strength_map(torch.from_numpy(x))).numpy()
        np.testing.assert_array_equal(reference.fast_nms(x), want)


def test_pyramid_equals_the_ports_to_float32():
    from slam_framework_torch.ops import pyramid

    img = np.random.default_rng(3).integers(0, 256, (94, 310)).astype(np.uint8)
    want = pyramid.build_pyramid(torch.from_numpy(img).float(), 8, 1.2)
    got = reference.pyramid(img, 8, 1.2)
    assert [g.shape for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        assert np.abs(g - w.numpy()).max() < 1e-3


def test_alignment_recovers_a_similarity():
    rng = np.random.default_rng(4)
    gt = np.tile(np.eye(4), (20, 1, 1))
    gt[:, :3, 3] = rng.normal(size=(20, 3)) * 5
    c, s = np.cos(0.3), np.sin(0.3)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    est = gt.copy()
    # est = gt seen from another world frame and at half the scale
    est[:, :3, :3] = gt[:, :3, :3] @ R.T
    est[:, :3, 3] = 0.5 * gt[:, :3, 3]
    err, scale = reference.ate(est, gt, with_scale=True)
    assert err < 1e-9 and scale == pytest.approx(2.0)


def test_surface_distance():
    pts = np.array([[500.0 - 490.0, 0.0, 0.0], [0.0, 1.65, 0.0], [500.0 - 495.0, -1.0, 0.0]])
    d = reference.surface_distance(pts, (500.0, 0.0), 490.0, 510.0, 1.65)
    np.testing.assert_allclose(d, [0.0, 0.0, 2.65])
