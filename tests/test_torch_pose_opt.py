"""Parity of the port's motion-only BA (optim/pose_opt.py, robust.py, reproj.py)
with the reference.

Tolerance: pose within 1e-4 (rotation entries and translation in metres) and
the same inlier set. Both run the same LM schedule in fp32; the port forms
the 6x6 normal equations as matrix products and solves them with a Cholesky
of the library, so sums are taken in another order. Near the optimum that
moves the pose by ~1e-6, far below the chi2 margins that classify inliers.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from slam_framework_tpu.geometry.projection import Intrinsics as JK
from slam_framework_tpu.optim import pose_opt as jpo
from slam_framework_tpu.optim import reproj as jreproj
from slam_framework_tpu.optim import robust as jrobust
from slam_framework_torch.geometry.projection import Intrinsics as TK
from slam_framework_torch.optim import pose_opt as tpo
from slam_framework_torch.optim import reproj as treproj
from slam_framework_torch.optim import robust as trobust

K = (400.0, 400.0, 320.0, 120.0, 216.0)


def _problem(seed, n=300, outliers=0.15, stereo=0.6, masked=0.1, init_noise=0.02):
    rng = np.random.default_rng(seed)
    T = np.eye(4)
    T[:3, :3] = Rotation.from_rotvec(rng.normal(0, 0.1, 3)).as_matrix()
    T[:3, 3] = rng.normal(0, 1.0, 3)
    Xc = np.stack([rng.uniform(-8, 8, n), rng.uniform(-3, 3, n), rng.uniform(3, 40, n)], 1)
    Xw = (T[:3, :3].T @ (Xc - T[:3, 3]).T).T
    fx, fy, cx, cy, bf = K
    u = fx * Xc[:, 0] / Xc[:, 2] + cx + rng.normal(0, 0.7, n)
    v = fy * Xc[:, 1] / Xc[:, 2] + cy + rng.normal(0, 0.7, n)
    ur = u - bf / Xc[:, 2] + rng.normal(0, 0.5, n)
    bad = rng.random(n) < outliers
    u = np.where(bad, u + rng.uniform(-60, 60, n), u)
    ur = np.where(rng.random(n) < stereo, ur, -1.0)
    octave = rng.integers(0, 4, n)
    T0 = np.eye(4)
    T0[:3, :3] = Rotation.from_rotvec(rng.normal(0, init_noise, 3)).as_matrix() @ T[:3, :3]
    T0[:3, 3] = T[:3, 3] + rng.normal(0, init_noise * 10, 3)
    f32 = np.float32
    return dict(
        T0=T0.astype(f32), points_w=Xw.astype(f32), uv=np.stack([u, v], 1).astype(f32),
        ur=ur.astype(f32), inv_sigma2=(1.0 / 1.2 ** (2.0 * octave)).astype(f32),
        mask=rng.random(n) >= masked,
    )


@pytest.mark.parametrize("seed,rounds,iters", [(0, 3, 4), (1, 4, 6), (2, 4, 10), (3, 3, 4)])
def test_optimize_pose_matches_reference(seed, rounds, iters):
    p = _problem(seed)
    fields = ("points_w", "uv", "ur", "inv_sigma2", "mask")
    jres = jax.jit(jpo.optimize_pose, static_argnums=(2, 3, 4))(
        jnp.asarray(p["T0"]), jpo.PoseObs(*[jnp.asarray(p[f]) for f in fields]), JK(*K), rounds, iters)
    tres = tpo.optimize_pose(
        torch.from_numpy(p["T0"]), tpo.PoseObs(*[torch.from_numpy(p[f]) for f in fields]), TK(*K), rounds, iters)
    np.testing.assert_allclose(tres.pose.numpy(), np.asarray(jres.pose), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tres.inliers.numpy(), np.asarray(jres.inliers))
    assert int(tres.num_inliers) == int(jres.num_inliers) > 100


def test_huber_and_camera_rows_match_reference():
    rng = np.random.default_rng(4)
    chi2 = rng.uniform(0, 30, 200).astype(np.float32)
    np.testing.assert_allclose(trobust.huber_weight(torch.from_numpy(chi2), trobust.CHI2_STEREO).numpy(),
                               np.asarray(jrobust.huber_weight(jnp.asarray(chi2), jrobust.CHI2_STEREO)),
                               rtol=1e-6)
    x, y = rng.uniform(-5, 5, (2, 100)).astype(np.float32)
    z = rng.uniform(1, 40, 100).astype(np.float32)
    got = treproj.camera_rows(*map(torch.from_numpy, (x, y, z)), TK(*K))
    want = jreproj.camera_rows(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), JK(*K))
    for g_rows, w_rows in zip(got[:3], want[:3]):
        for g, w in zip(g_rows, w_rows):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
