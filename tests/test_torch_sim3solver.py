"""Parity of the port's Sim3 solver with the reference (solvers/sim3solver.py):
seeded numpy scenes through both packages.

`horn_alignment` and `refine_sim3`: R, t, s within 1e-4 of the reference, the
same inlier set. `solve_sim3_ransac`: the reference draws its 256 triplets
inside, from a `jax.random` key; the test draws the very same sets with
`jax.random.choice` from that key and hands them to the port, which takes index
sets instead of a key. Compared after refinement (a triplet with a repeated
index has an arbitrary eigenvector, so the 256 hypotheses are not compared one
by one): R and t within 1e-4, the inlier sets equal up to 2 flips. The port's
own sampler is held by its contract: indices of valid matches only, the same
stream from the same seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_framework_tpu.geometry import se3 as jse3
from slam_framework_tpu.geometry.projection import Intrinsics as JIntrinsics
from slam_framework_tpu.solvers import sim3solver as jsolver
from slam_framework_torch.geometry.projection import Intrinsics as TIntrinsics
from slam_framework_torch.solvers import sim3solver as tsolver


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
TOL = 1e-4


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _proj(P):
    return np.stack([JK.fx * P[:, 0] / P[:, 2] + JK.cx, JK.fy * P[:, 1] / P[:, 2] + JK.cy], -1).astype(np.float32)


def _two_view(seed, n=200, n_valid=120, n_out=36, s_true=1.0, noise_px=0.5):
    """Matched points of two keyframes under a known Sim3, pixel noise, gross
    3-D outliers among the valid matches and padded (masked) slots behind them."""
    rng = np.random.default_rng(seed)
    pts2 = np.stack([rng.uniform(-8, 8, n), rng.uniform(-3, 3, n), rng.uniform(5, 30, n)], -1).astype(np.float32)
    R_true = np.asarray(jse3.so3_exp(jnp.asarray([0.05, 0.3, -0.02])), np.float32)
    t_true = np.array([2.0, 0.3, -1.0], np.float32)
    pts1 = (s_true * (R_true @ pts2.T)).T + t_true
    uv1 = _proj(pts1) + rng.normal(0, noise_px, (n, 2)).astype(np.float32)
    uv2 = _proj(pts2) + rng.normal(0, noise_px, (n, 2)).astype(np.float32)
    pts1_n = pts1.copy()
    out = rng.choice(n_valid, n_out, replace=False)
    pts1_n[out] += rng.uniform(2, 6, (n_out, 3)).astype(np.float32)
    mask = np.arange(n) < n_valid
    s2_1 = (1.44 ** rng.integers(0, 4, n)).astype(np.float32)
    s2_2 = (1.44 ** rng.integers(0, 4, n)).astype(np.float32)
    return dict(pts1=pts1_n.astype(np.float32), pts2=pts2, uv1=uv1, uv2=uv2, s2_1=s2_1, s2_2=s2_2, mask=mask,
                R=R_true, t=t_true, s=s_true, out=out)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_horn_alignment_matches_reference(fix_scale):
    rng = np.random.default_rng(0)
    p2 = rng.uniform(-5, 5, (64, 3, 3)).astype(np.float32)  # 64 hypotheses of 3 points
    R_true = np.asarray(jse3.so3_exp(jnp.asarray([0.2, -0.1, 0.3])))
    p1 = (1.7 * np.einsum("ij,hsj->hsi", R_true, p2) + np.array([1.0, -2.0, 0.5])).astype(np.float32)
    p1 += rng.normal(0, 0.01, p1.shape).astype(np.float32)
    want = jsolver.horn_alignment(jnp.asarray(p1), jnp.asarray(p2), fix_scale)
    got = tsolver.horn_alignment(*_t(p1, p2), fix_scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)
    # the exact case of the reference's own test
    p2e = rng.uniform(-5, 5, (10, 3)).astype(np.float32)
    p1e = ((1.7 * (R_true @ p2e.T)).T + np.array([1.0, -2.0, 0.5])).astype(np.float32)
    R, t, s = tsolver.horn_alignment(*_t(p1e, p2e), fix_scale=False)
    np.testing.assert_allclose(R.numpy(), R_true, atol=1e-4)
    np.testing.assert_allclose(float(s), 1.7, rtol=1e-4)
    np.testing.assert_allclose(t.numpy(), [1.0, -2.0, 0.5], atol=1e-3)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_refine_sim3_matches_reference(fix_scale):
    sc = _two_view(1, n_out=10, s_true=1.0 if fix_scale else 1.4)
    R0 = np.asarray(jse3.so3_exp(jnp.asarray([0.07, 0.27, 0.0])), np.float32)
    t0 = sc["t"] + np.array([0.2, -0.15, 0.1], np.float32)
    s0 = np.float32(1.0 if fix_scale else 1.3)
    args = (sc["pts1"], sc["pts2"], sc["uv1"], sc["uv2"], sc["s2_1"], sc["s2_2"], sc["mask"])
    want = jsolver.refine_sim3(jnp.asarray(R0), jnp.asarray(t0), jnp.float32(s0), *map(jnp.asarray, args), JK,
                               fix_scale=fix_scale)
    got = tsolver.refine_sim3(*_t(R0, t0), torch.tensor(s0), *_t(*args), TK, fix_scale=fix_scale)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)
    assert int((got[3].numpy() != np.asarray(want[3])).sum()) <= 2
    assert abs(int(got[4]) - int(want[4])) <= 2 and int(got[4]) >= 100
    assert not got[3].numpy()[~sc["mask"]].any()
    np.testing.assert_allclose(got[0].numpy(), sc["R"], atol=5e-3)
    np.testing.assert_allclose(float(got[2]), sc["s"], rtol=5e-3)
    if fix_scale:
        assert float(got[2]) == 1.0


@pytest.mark.parametrize("seed,fix_scale", [(2, True), (3, True), (4, False), (5, False)])
def test_ransac_with_the_reference_s_index_sets(seed, fix_scale):
    sc = _two_view(seed, s_true=1.0 if fix_scale else 1.25)
    key = jax.random.PRNGKey(seed)
    args = (sc["pts1"], sc["pts2"], sc["uv1"], sc["uv2"], sc["s2_1"], sc["s2_2"], sc["mask"])
    want = jsolver.solve_sim3_ransac(*map(jnp.asarray, args), JK, key, fix_scale=fix_scale)
    # the draw solve_sim3_ransac makes inside from this key
    n = len(sc["mask"])
    probs = jnp.asarray(sc["mask"]).astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    idx = np.asarray(jax.random.choice(key, n, shape=(256, 3), replace=True, p=probs))
    assert sc["mask"][idx].all()
    got = tsolver.solve_sim3_ransac(*_t(*args), TK, torch.from_numpy(idx.astype(np.int64)), fix_scale=fix_scale)
    assert bool(got.ok) and bool(want.ok)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=TOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=TOL)
    np.testing.assert_allclose(float(got.s), float(want.s), atol=TOL)
    flips = int((got.inliers.numpy() != np.asarray(want.inliers)).sum())
    assert flips <= 2, flips
    assert abs(int(got.n_inliers) - int(want.n_inliers)) <= 2
    # gross outliers are out, the truth is found
    assert got.inliers.numpy()[sc["out"]].mean() < 0.1 and int(got.n_inliers) >= 70
    np.testing.assert_allclose(got.R.numpy(), sc["R"], atol=0.02)


def test_sampler_draws_valid_matches_from_a_seeded_host_generator():
    mask = torch.zeros(300, dtype=torch.bool)
    mask[torch.arange(0, 300, 7)] = True
    a = tsolver.sample_index_sets(mask, 256, torch.Generator().manual_seed(7))
    b = tsolver.sample_index_sets(mask, 256, torch.Generator().manual_seed(7))
    assert a.shape == (256, 3) and a.dtype == torch.long and a.device.type == "cpu"
    assert torch.equal(a, b) and bool(mask[a].all())
    g = torch.Generator().manual_seed(7)
    first, second = tsolver.sample_index_sets(mask, 256, g), tsolver.sample_index_sets(mask, 256, g)
    assert torch.equal(first, a) and not torch.equal(second, a)
    assert len(torch.unique(a)) > 30  # spread over the 43 valid matches
