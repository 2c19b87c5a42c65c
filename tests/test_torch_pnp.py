"""Parity of the port's PnP solvers with the reference (solvers/pnp.py): seeded
numpy scenes (those of tests/test_solvers.py, copied here, plus a stereo scene for
the 3-D solver) through both packages.

`_dlt_resection` and `_gn_refine_pose` on the same batch: within 1e-4 (the DLT's
translation within 1e-3 m, see the test). The RANSAC
solvers draw their index sets inside, from a `jax.random` key; the test draws the
very same sets with `jax.random.choice` from that key and hands them to the port,
which takes index sets. Compared: R within 1e-4, t within 1e-3 m, `n_inliers`
within 2, the same `ok`; garbage input is refused by both. The reference's median
of the six depths is the mean of the two middle values: a set whose lower median
has the other sign holds the port to it, under either eigenvector sign.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_framework_tpu.geometry import se3 as jse3
from slam_framework_tpu.geometry.projection import Intrinsics as JIntrinsics
from slam_framework_tpu.solvers import pnp as jpnp
from slam_framework_torch.geometry.projection import Intrinsics as TIntrinsics
from slam_framework_torch.solvers import pnp as tpnp
from slam_framework_torch.solvers import sim3solver as tsim3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; torch's default of one
    thread per core in each of them oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


JK = JIntrinsics(fx=718.856, fy=718.856, cx=607.19, cy=185.22, bf=386.1448)
TK = TIntrinsics(*JK)
TOL_R = 1e-4
TOL_T = 1e-3
# the reference solvers compiled once per shape (op by op they take seconds a call)
J_PNP = jax.jit(functools.partial(jpnp.solve_pnp_ransac, K=JK))
J_PNP3D = jax.jit(functools.partial(jpnp.solve_pnp3d_ransac, K=JK), static_argnames="min_inliers")
J_DLT = jax.jit(jpnp._dlt_resection)
J_GN = jax.jit(functools.partial(jpnp._gn_refine_pose, K=JK, iters=5))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def make_pnp_problem(rng, n=60, outlier_frac=0.3, noise=0.5):
    """tests/test_solvers.py's PnP scene: world points, a random pose, pixel
    noise and gross pixel outliers."""
    pts = np.stack([rng.uniform(-10, 10, n), rng.uniform(-4, 4, n), rng.uniform(5, 40, n)], -1).astype(np.float32)
    xi = rng.normal(size=6).astype(np.float32) * 0.2
    T = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    Xc = (T[:3, :3] @ pts.T).T + T[:3, 3]
    u = JK.fx * Xc[:, 0] / Xc[:, 2] + JK.cx + rng.normal(0, noise, n)
    v = JK.fy * Xc[:, 1] / Xc[:, 2] + JK.cy + rng.normal(0, noise, n)
    n_out = int(n * outlier_frac)
    out = rng.choice(n, n_out, replace=False)
    u[out] += rng.uniform(30, 200, n_out) * rng.choice([-1, 1], n_out)
    uv = np.stack([u, v], -1).astype(np.float32)
    return pts, uv, T, out, Xc


def make_stereo_problem(rng, n=300, n_slots=400, outlier_frac=0.3):
    """A stereo relocalization set: matched world points, their pixels and the
    keypoints back-projected through a noisy stereo depth (sigma_z ~ z^2/bf),
    gross outliers among the matches and masked slots behind them."""
    pts, uv, T, out, Xc = make_pnp_problem(rng, n=n, outlier_frac=outlier_frac)
    z = Xc[:, 2] + rng.normal(0, 1, n) * Xc[:, 2] ** 2 / JK.bf * 0.05
    pts_c = np.stack([(uv[:, 0] - JK.cx) * z / JK.fx, (uv[:, 1] - JK.cy) * z / JK.fy, z], -1)
    pad = n_slots - n
    pts_w = np.concatenate([pts, np.zeros((pad, 3))]).astype(np.float32)
    pts_c = np.concatenate([pts_c, np.zeros((pad, 3))]).astype(np.float32)
    uv = np.concatenate([uv, np.zeros((pad, 2))]).astype(np.float32)
    inv_s2 = (1.0 / 1.44 ** rng.integers(0, 4, n_slots)).astype(np.float32)
    mask = np.arange(n_slots) < n
    mask[rng.choice(n, n // 10, replace=False)] = False  # no stereo depth
    return pts_w, pts_c, uv, inv_s2, mask, T, out


def _reference_sets(key, mask, set_size, H=256):
    """The draw the reference solvers make inside from `key`."""
    probs = jnp.asarray(mask).astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    idx = np.asarray(jax.random.choice(key, len(mask), shape=(H, set_size), replace=True, p=probs))
    return torch.from_numpy(idx.astype(np.int64))


def _assert_same_result(got, want):
    np.testing.assert_allclose(got.pose[:3, :3].numpy(), np.asarray(want.pose)[:3, :3], atol=TOL_R)
    np.testing.assert_allclose(got.pose[:3, 3].numpy(), np.asarray(want.pose)[:3, 3], atol=TOL_T)
    assert abs(int(got.n_inliers) - int(want.n_inliers)) <= 2
    assert bool(got.ok) == bool(want.ok)


def test_dlt_resection_and_gn_refine_match_reference():
    rng = np.random.default_rng(0)
    pts, uv, T, out, _ = make_pnp_problem(rng, n=120, outlier_frac=0.0, noise=0.5)
    # 40 points per set: a 6-point set leaves one redundant equation, and the
    # smallest eigenvector of its fp32 normal matrix is rounding noise at the
    # 1e-3 level in BOTH packages (each ~0.1 from a float64 solve on this
    # scene). Even at 40 points the depth direction of this narrow 5-40 m scene
    # leaves the translation 1.5e-4 m apart (also with 0.1 px of noise): it is
    # held to the solvers' 1e-3 m, the rotation to 1e-4.
    sets = np.stack([rng.choice(len(pts), 40, replace=False) for _ in range(64)])
    uvn = np.stack([(uv[:, 0] - JK.cx) / JK.fx, (uv[:, 1] - JK.cy) / JK.fy], -1).astype(np.float32)
    want = J_DLT(jnp.asarray(pts[sets]), jnp.asarray(uvn[sets]))
    got = tpnp._dlt_resection(*_t(pts[sets], uvn[sets]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=TOL_R)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=TOL_T)
    # reprojection Gauss-Newton from perturbed truths on the same sets, weights with zeros
    R0 = np.stack([np.asarray(jse3.so3_exp(jnp.asarray(rng.normal(0, 0.03, 3)))) @ T[:3, :3] for _ in range(64)])
    t0 = (T[:3, 3] + rng.normal(0, 0.3, (64, 3))).astype(np.float32)
    w = (rng.uniform(size=(64, 40)) > 0.1).astype(np.float32)
    want = J_GN(jnp.asarray(R0, jnp.float32), jnp.asarray(t0), jnp.asarray(pts[sets]),
                jnp.asarray(uv[sets]), jnp.asarray(w))
    got = tpnp._gn_refine_pose(*_t(R0.astype(np.float32), t0, pts[sets], uv[sets], w), TK, iters=5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=TOL_R)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=TOL_R)


@pytest.mark.parametrize("seed,outlier_frac", [(0, 0.3), (1, 0.1), (2, 0.4)])
def test_solve_pnp_ransac_with_the_reference_s_index_sets(seed, outlier_frac):
    rng = np.random.default_rng(seed)
    pts, uv, T, out, _ = make_pnp_problem(rng, n=80, outlier_frac=outlier_frac)
    n = len(pts)
    inv_s2, mask = np.ones(n, np.float32), np.ones(n, bool)
    key = jax.random.PRNGKey(seed)
    want = J_PNP(*map(jnp.asarray, (pts, uv, inv_s2, mask)), key=key)
    got = tpnp.solve_pnp_ransac(*_t(pts, uv, inv_s2, mask), TK, _reference_sets(key, mask, tpnp.MIN_SET))
    _assert_same_result(got, want)
    assert bool(got.ok)
    d = got.pose.numpy() @ np.linalg.inv(T)
    assert np.linalg.norm(d[:3, 3]) < 0.35  # the reference test's bound
    assert got.inliers.numpy()[out].mean() < 0.15


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_solve_pnp3d_ransac_with_the_reference_s_index_sets(seed):
    rng = np.random.default_rng(seed)
    pts_w, pts_c, uv, inv_s2, mask, T, out = make_stereo_problem(rng)
    key = jax.random.PRNGKey(seed)
    want = J_PNP3D(*map(jnp.asarray, (pts_w, pts_c, uv, inv_s2, mask)), key=key, min_inliers=6)
    got = tpnp.solve_pnp3d_ransac(*_t(pts_w, pts_c, uv, inv_s2, mask), TK, _reference_sets(key, mask, 3),
                                  min_inliers=6)
    _assert_same_result(got, want)
    assert bool(got.ok) and int(got.n_inliers) >= 150
    d = got.pose.numpy() @ np.linalg.inv(T)
    assert np.linalg.norm(d[:3, 3]) < 0.05
    assert not got.inliers.numpy()[out].any()


@pytest.mark.parametrize("solver", ["2d", "3d"])
def test_garbage_is_refused_by_both(solver):
    rng = np.random.default_rng(1)
    n = 40
    pts = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    uv = rng.uniform(0, 1000, (n, 2)).astype(np.float32)
    pts_c = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    pts_c[:, 2] = np.abs(pts_c[:, 2]) + 1
    inv_s2, mask = np.ones(n, np.float32), np.ones(n, bool)
    key = jax.random.PRNGKey(1)
    if solver == "2d":
        want = J_PNP(*map(jnp.asarray, (pts, uv, inv_s2, mask)), key=key)
        got = tpnp.solve_pnp_ransac(*_t(pts, uv, inv_s2, mask), TK, _reference_sets(key, mask, tpnp.MIN_SET))
    else:
        want = J_PNP3D(*map(jnp.asarray, (pts, pts_c, uv, inv_s2, mask)), key=key, min_inliers=10)
        got = tpnp.solve_pnp3d_ransac(*_t(pts, pts_c, uv, inv_s2, mask), TK, _reference_sets(key, mask, 3))
    assert not bool(want.ok) and not bool(got.ok)
    assert int(got.n_inliers) < n


@pytest.mark.parametrize("negate", [False, True])
def test_cheirality_takes_the_mean_of_the_two_middle_depths(monkeypatch, negate):
    """Three of the six points lie behind the camera; the two middle depths are
    -0.5 and 2 m: their mean is positive, the lower one is not. The set is exact,
    so the DLT recovers the pose up to the eigenvector's sign, and the flip must
    settle it the reference's way whichever sign the solver returns."""
    T = np.asarray(jse3.se3_exp(jnp.asarray([0.3, -0.2, 0.5, 0.05, -0.1, 0.02])), np.float32)
    depths = np.array([-3.0, -2.0, -0.5, 2.0, 5.0, 6.0])
    xy = np.array([[0.3, 0.1], [-0.2, 0.4], [0.5, -0.3], [-0.4, -0.2], [0.1, 0.25], [0.35, -0.15]])
    Xc = np.concatenate([xy * depths[:, None], depths[:, None]], -1)
    pts = ((Xc - T[:3, 3]) @ T[:3, :3]).astype(np.float32)  # world = R^T (Xc - t)
    uvn = (Xc[:, :2] / Xc[:, 2:]).astype(np.float32)
    want = jpnp._dlt_resection(jnp.asarray(pts[None]), jnp.asarray(uvn[None]))
    if negate:
        eigh = torch.linalg.eigh

        def negated(a):
            w, v = eigh(a)
            return w, -v

        monkeypatch.setattr(torch.linalg, "eigh", negated)
    got = tpnp._dlt_resection(*_t(pts[None], uvn[None]))
    np.testing.assert_allclose(got[0][0].numpy(), np.asarray(want[0])[0], atol=TOL_R)
    np.testing.assert_allclose(got[0][0].numpy(), T[:3, :3], atol=1e-3)
    np.testing.assert_allclose(got[1][0].numpy(), T[:3, 3], atol=1e-2)
    # the lower median would have flipped it
    z = torch.tensor(depths, dtype=torch.float32)
    assert float(torch.median(z)) < 0 < float(torch.quantile(z, 0.5))


def test_sampler_draws_sets_of_the_requested_size():
    mask = torch.zeros(300, dtype=torch.bool)
    mask[torch.arange(0, 300, 7)] = True
    sets = tsim3.sample_index_sets(mask, 256, torch.Generator().manual_seed(11), set_size=tpnp.MIN_SET)
    assert sets.shape == (256, tpnp.MIN_SET) and bool(mask[sets].all())
    again = tsim3.sample_index_sets(mask, 256, torch.Generator().manual_seed(11), set_size=tpnp.MIN_SET)
    assert torch.equal(sets, again)
