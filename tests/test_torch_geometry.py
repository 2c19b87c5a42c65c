"""Parity of the port's SE3 / projection ops with the reference (geometry/se3.py,
geometry/projection.py).

Tolerance: 1e-5 relative (plus 1e-6 absolute near zero). Both sides compute in
fp32 with the same closed forms; only the summation order of the 3x3 products
and the libm of sin/cos/atan2 differ, which stays within a few ulp.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from slam_framework_tpu.geometry import projection as jproj
from slam_framework_tpu.geometry import se3 as jse3
from slam_framework_torch.geometry import projection as tproj
from slam_framework_torch.geometry import se3 as tse3

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def _twists(seed, n=16, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 6)) * scale).astype(np.float32)


def _poses(seed, n=8):
    rng = np.random.default_rng(seed)
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = Rotation.random(n, random_state=seed).as_matrix().astype(np.float32)
    T[:, :3, 3] = rng.standard_normal((n, 3)).astype(np.float32) * 5
    return T


@pytest.mark.parametrize("scale", [1e-5, 1e-2, 1.0])
def test_so3_exp(scale):
    w = _twists(1, scale=scale)[:, :3]
    _close(tse3.so3_exp(torch.from_numpy(w)), jse3.so3_exp(jnp.asarray(w)))


@pytest.mark.parametrize("kind", ["random", "small", "near_pi"])
def test_so3_log(kind):
    rng = np.random.default_rng(2)
    if kind == "random":
        R = Rotation.random(16, random_state=3).as_matrix()
    elif kind == "small":
        R = Rotation.from_rotvec(rng.standard_normal((16, 3)) * 1e-4).as_matrix()
    else:
        ax = rng.standard_normal((16, 3))
        ax /= np.linalg.norm(ax, axis=1, keepdims=True)
        R = Rotation.from_rotvec(ax * (np.pi - 1e-4)).as_matrix()
    R = R.astype(np.float32)
    got = tse3.so3_log(torch.from_numpy(R)).numpy()
    want = np.asarray(jse3.so3_log(jnp.asarray(R)))
    # near pi the axis sign is a convention; both pick it the same way
    np.testing.assert_allclose(got, want, rtol=1e-4 if kind == "near_pi" else RTOL, atol=1e-5)


@pytest.mark.parametrize("scale", [1e-5, 0.5])
def test_se3_exp(scale):
    xi = _twists(4, scale=scale)
    _close(tse3.se3_exp(torch.from_numpy(xi)), jse3.se3_exp(jnp.asarray(xi)))


@pytest.mark.parametrize("op", ["inverse", "compose", "reorthonormalize"])
def test_pose_ops(op):
    A, B = _poses(5), _poses(6)
    tA, tB, jA, jB = torch.from_numpy(A), torch.from_numpy(B), jnp.asarray(A), jnp.asarray(B)
    if op == "inverse":
        _close(tse3.se3_inverse(tA), jse3.se3_inverse(jA))
    elif op == "compose":
        _close(tse3.compose(tA, tB), jse3.compose(jA, jB))
    else:
        noisy = A.copy()
        noisy[:, :3, :3] += np.random.default_rng(0).standard_normal((8, 3, 3)).astype(np.float32) * 1e-3
        _close(tse3.reorthonormalize(torch.from_numpy(noisy)), jse3.reorthonormalize(jnp.asarray(noisy)))


def test_transform_points():
    T = _poses(7)[0]
    pts = np.random.default_rng(8).standard_normal((50, 3)).astype(np.float32) * 10
    _close(tse3.transform_points(torch.from_numpy(T), torch.from_numpy(pts)),
           jse3.transform_points(jnp.asarray(T), jnp.asarray(pts)))


def test_undistortion():
    K = (400.0, 410.0, 320.0, 120.0, 216.0)
    tK, jK = tproj.Intrinsics(*K), jproj.Intrinsics(*K)
    rng = np.random.default_rng(9)
    dist = (0.05, -0.01, 0.001, -0.002, 0.0005)
    uv = rng.uniform([0, 0], [640, 240], (60, 2)).astype(np.float32)
    _close(tproj.undistort_points(torch.from_numpy(uv), tK, dist),
           jproj.undistort_points(jnp.asarray(uv), jK, jnp.asarray(dist, jnp.float32)))
    assert tK.baseline == jK.baseline
