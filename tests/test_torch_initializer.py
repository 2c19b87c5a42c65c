"""Parity of the port's two-view initializer with the reference
(solvers/initializer.py), function by function, on seeded two-view scenes: a
general 3-D scene under mixed sideways and forward motion (the essential-matrix
path wins) and an oblique plane (the homography path wins), 300 matches with
0.1 px of pixel noise and 20% gross outliers in 400 slots.

Every function gets the reference's own inputs. Tolerances, with their reasons:
  - `_normalize`, the chi2 scorers, `_check_motions`: fp32 sums in another
    order, 1e-4 relative (1e-3 m on points, 1e-3 degrees of parallax); the
    counted sets equal up to 2 borderline points;
  - the minimal 8-point E and DLT H: the smallest eigenvector of an fp32 9x9
    AtA, whose conditioning is squared, so each hypothesis is noise-level off
    the fp64 solution in both packages (measured ~4e-3 in both at 0.5 px of
    noise) and the two differ by as much. Each package's hypotheses are held to
    the fp64 solution (the port's median error at most 1.5x the reference's);
    the weighted refits over all points agree within 1e-3 (up to sign; the E
    refit on the general scene only: a plane leaves it a 3-dimensional null space);
  - `_decompose_H`: the same 8 motions as a set (their order follows the SVD's
    signs), within 1e-4;
  - `initialize_two_view`, fed the reference's `PRNGKey` draw: the same `ok` and
    model, R within 1e-3, t within 2e-3, the same good points up to 1%. At 0.1 px
    every good hypothesis finds the same inlier set, so which of the near-equal
    hypotheses scores best does not matter. At 0.5 px it does: the two packages
    then pick different winners on some draws, R differs by up to 6e-3 and on
    one draw of 16 only one package accepts the pair (measured on the general
    scene, seeds 3-6, keys 0-1), as a different draw would do in either.
The sign case: every SVD the port makes is handed singular vectors of flipped
signs, and the result must not change.

The bench pair: the bench world's first monocular attempt (frames 0 and 1 at
`SlamConfig()` defaults: the 2x-feature front-end's 2,029 matches and the
inliers of the best E and H hypotheses, recorded on the CPU in
tests/data/bench_mono_init_pair.npz). Its weighted refits are held to the
float64 solution within 1e-6 (sign-free, unit norm), which makes them the same
on every device, and to the reference's within 2e-3 (the reference's float32
refit of E is 4.5e-4 from the float64 one there; on an H100 the port's float32
refit was 0.21 off it and the initialization started two frames late).
"""

import os


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_framework_tpu.geometry.projection import Intrinsics as JIntrinsics
from slam_framework_tpu.solvers import initializer as jinit
from slam_framework_torch.geometry.projection import Intrinsics as TIntrinsics
from slam_framework_torch.solvers import initializer as tinit


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; torch's default of one
    thread per core in each of them oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


JK = JIntrinsics(fx=400.0, fy=400.0, cx=320.0, cy=120.0, bf=0.0)
TK = TIntrinsics(*JK)
N_SLOTS, N_VALID, N_OUT = 400, 300, 60


def _rot(w):
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    Wx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    return np.eye(3) + np.sin(th) / th * Wx + (1 - np.cos(th)) / th ** 2 * (Wx @ Wx)


def _scene(kind: str, seed: int, noise_px: float = 0.1):
    """uv1, uv2 (N_SLOTS, 2) pixels, mask, the true R, unit t and the outliers."""
    rng = np.random.default_rng(seed)
    n = N_SLOTS
    if kind == "general":
        X = np.stack([rng.uniform(-8, 8, n), rng.uniform(-3, 3, n), rng.uniform(3, 15, n)], -1)
        R, t = _rot([0.02, 0.08, -0.01]), np.array([0.7, 0.05, 0.5])
    else:  # the plane z = 5 - 0.6 x + 0.4 y
        xy = np.stack([rng.uniform(-5, 5, n), rng.uniform(-2.5, 2.5, n)], -1)
        X = np.stack([xy[:, 0], xy[:, 1], 5.0 - 0.6 * xy[:, 0] + 0.4 * xy[:, 1]], -1)
        R, t = _rot([0.03, 0.1, 0.02]), np.array([1.2, 0.3, -0.4])
    X2 = X @ R.T + t

    def proj(P):
        return np.stack([JK.fx * P[:, 0] / P[:, 2] + JK.cx, JK.fy * P[:, 1] / P[:, 2] + JK.cy], -1)

    uv1 = proj(X) + rng.normal(0, noise_px, (n, 2))
    uv2 = proj(X2) + rng.normal(0, noise_px, (n, 2))
    out = rng.choice(N_VALID, N_OUT, replace=False)
    uv2[out] += rng.uniform(15, 60, (N_OUT, 2)) * rng.choice([-1, 1], (N_OUT, 2))
    mask = np.arange(n) < N_VALID
    uv1[~mask] = 0.0
    uv2[~mask] = 0.0
    return (uv1.astype(np.float32), uv2.astype(np.float32), mask, R.astype(np.float32),
            (t / np.linalg.norm(t)).astype(np.float32), out)


def _reference_draw(mask, key):
    """The draw `initialize_two_view` makes inside from `key`."""
    probs = jnp.asarray(mask).astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    return np.asarray(jax.random.choice(key, len(mask), shape=(200, 8), replace=True, p=probs))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _unit_sign(M):
    """M / |M| with the sign fixed by its largest-magnitude entry, per batch row."""
    flat = M.reshape(M.shape[0], -1) if M.ndim > 2 else M.reshape(1, -1)
    flat = flat / np.linalg.norm(flat, axis=1, keepdims=True)
    lead = flat[np.arange(len(flat)), np.argmax(np.abs(flat), axis=1)]
    return flat * np.sign(lead)[:, None]


@pytest.fixture(scope="module", params=["general", "planar"])
def scene(request):
    return request.param, _scene(request.param, seed=3 if request.param == "general" else 4)


def test_normalize_and_scorers_match_reference(scene):
    _, (uv1, uv2, mask, R, t, _) = scene
    x1 = np.asarray(jinit._normalize(jnp.asarray(uv1), JK))
    x2 = np.asarray(jinit._normalize(jnp.asarray(uv2), JK))
    np.testing.assert_allclose(tinit._normalize(torch.from_numpy(uv1), TK).numpy(), x1, rtol=1e-6, atol=1e-7)
    # the true E and H-ish matrices and a few perturbed ones, as (H, 3, 3) hypotheses
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]], np.float32)
    rng = np.random.default_rng(0)
    Es = np.stack([tx @ R] + [tx @ R + rng.normal(0, 0.01, (3, 3)).astype(np.float32) for _ in range(3)])
    want = np.asarray(jinit._sampson_chi2(jnp.asarray(Es), jnp.asarray(x1), jnp.asarray(x2), JK))
    got = tinit._sampson_chi2(*_t(Es, x1, x2), TK).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    Hs = np.stack([R + np.outer(t, [0.0, 0.0, 0.1])] + [R + rng.normal(0, 0.01, (3, 3)) for _ in range(3)])
    Hs = Hs.astype(np.float32)
    want = np.asarray(jinit._transfer_chi2_H(jnp.asarray(Hs), jnp.asarray(x1), jnp.asarray(x2), JK))
    got = tinit._transfer_chi2_H(*_t(Hs, x1, x2), TK).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def _fp64_minimal(x1, x2, model):
    """The minimal solver in fp64 through an SVD of A itself: (8, 2) -> (3, 3)."""
    x1, x2 = x1.astype(np.float64), x2.astype(np.float64)
    if model == "E":
        A = np.stack([x2[:, 0] * x1[:, 0], x2[:, 0] * x1[:, 1], x2[:, 0], x2[:, 1] * x1[:, 0],
                      x2[:, 1] * x1[:, 1], x2[:, 1], x1[:, 0], x1[:, 1], np.ones(len(x1))], -1)
        E = np.linalg.svd(A)[2][-1].reshape(3, 3)
        U, _, Vt = np.linalg.svd(E)
        return U @ np.diag([1.0, 1.0, 0.0]) @ Vt
    xh = np.concatenate([x1, np.ones((len(x1), 1))], -1)
    z = np.zeros_like(xh)
    A = np.concatenate([np.concatenate([xh, z, -x2[:, 0:1] * xh], -1), np.concatenate([z, xh, -x2[:, 1:2] * xh], -1)])
    return np.linalg.svd(A)[2][-1].reshape(3, 3)


def test_eight_point_E_and_dlt_H_match_reference(scene):
    kind, (uv1, uv2, mask, *_rest) = scene
    x1 = np.asarray(jinit._normalize(jnp.asarray(uv1), JK))
    x2 = np.asarray(jinit._normalize(jnp.asarray(uv2), JK))
    sets = _reference_draw(mask, jax.random.PRNGKey(1))
    sets = sets[np.array([len(set(s)) == 8 for s in sets])]  # a repeated index leaves it ill-posed
    for model, jfn, tfn in (("E", jinit._eight_point_E, tinit._eight_point_E), ("H", jinit._dlt_H, tinit._dlt_H)):
        want = _unit_sign(np.asarray(jfn(jnp.asarray(x1[sets]), jnp.asarray(x2[sets]))))
        got = _unit_sign(tfn(*_t(x1[sets], x2[sets])).numpy())
        exact = _unit_sign(np.stack([_fp64_minimal(x1[s], x2[s], model) for s in sets]))
        err_got = np.median(np.abs(got - exact).max(axis=1))
        err_want = np.median(np.abs(want - exact).max(axis=1))
        assert err_got <= 1.5 * err_want + 1e-4, (model, err_got, err_want)
    w = (mask & (np.arange(N_SLOTS) % 3 != 0)).astype(np.float32)
    refits = [(jinit._dlt_H_weighted, tinit._dlt_H_weighted)]
    if kind == "general":  # on a plane the 8-point system has a 3-dimensional null space
        refits.append((jinit._eight_point_E_weighted, tinit._eight_point_E_weighted))
    for jfn, tfn in refits:
        want = np.asarray(jfn(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w)))
        got = tfn(*_t(x1, x2, w)).numpy()
        np.testing.assert_allclose(_unit_sign(got), _unit_sign(want), atol=1e-3)


def _motion_set_matches(Rs_a, ts_a, Rs_b, ts_b, tol):
    """Every motion of a has a motion of b within tol, one to one."""
    used = set()
    for R, t in zip(Rs_a, ts_a):
        d = [max(np.abs(R - R2).max(), np.abs(t - t2).max()) for R2, t2 in zip(Rs_b, ts_b)]
        j = int(np.argmin(d))
        assert d[j] < tol and j not in used, (d[j], j)
        used.add(j)


def test_decompose_H_gives_the_reference_motions():
    _, _, _, R, t, _ = _scene("planar", 4)
    n = np.array([0.1, -0.05, 1.0]) / 8.0
    for Hn in (R + np.outer(t, n), np.diag([1.2, 1.0, 0.7]) @ _rot([0.1, 0.2, 0.3])):
        Hn = Hn.astype(np.float32)
        jR, jt, jdeg = (np.asarray(a) for a in jinit._decompose_H(jnp.asarray(Hn)))
        tR, tt, tdeg = (a.numpy() for a in tinit._decompose_H(torch.from_numpy(Hn)))
        assert bool(tdeg) == bool(jdeg)
        _motion_set_matches(tR, tt, jR, jt, 1e-4)
        # a proper rotation each
        np.testing.assert_allclose(np.linalg.det(tR), 1.0, atol=1e-4)
    # a spectrum with d1 ~ d2 is flagged degenerate in both
    Hd = np.diag([1.0, 1.0, 0.5]).astype(np.float32)
    assert bool(tinit._decompose_H(torch.from_numpy(Hd))[2]) and bool(jinit._decompose_H(jnp.asarray(Hd))[2])


def test_check_motions_matches_reference(scene):
    _, (uv1, uv2, mask, R, t, out) = scene
    x1 = np.asarray(jinit._normalize(jnp.asarray(uv1), JK))
    x2 = np.asarray(jinit._normalize(jnp.asarray(uv2), JK))
    Rs = np.stack([R, R, R.T, _rot([0.0, 0.05, 0.0]).astype(np.float32)])
    ts = np.stack([t, -t, t, t]).astype(np.float32)
    m = np.stack([mask, mask, mask, mask & (np.arange(N_SLOTS) % 2 == 0)])
    want = [np.asarray(a) for a in jinit._check_motions(jnp.asarray(Rs), jnp.asarray(ts), jnp.asarray(x1),
                                                         jnp.asarray(x2), jnp.asarray(m), JK, 1.0)]
    got = [a.numpy() for a in tinit._check_motions(*_t(Rs, ts, x1, x2, m), TK, 1.0)]
    both = got[1] & want[1]
    np.testing.assert_allclose(got[0][both], want[0][both], rtol=1e-4, atol=1e-3)
    assert int((got[1] != want[1]).sum()) <= 2
    assert np.abs(got[2] - want[2]).max() <= 2
    np.testing.assert_allclose(got[3], want[3], atol=1e-3)
    # the true motion counts the inliers, its mirror none
    assert got[2][0] > 0.9 * (N_VALID - N_OUT) and got[2][1] < 10


@pytest.mark.parametrize("key", [0, 1])
def test_initialize_two_view_with_the_reference_draw(scene, key):
    kind, (uv1, uv2, mask, R, t, out) = scene
    k = jax.random.PRNGKey(key)
    want = jax.device_get(jinit.initialize_two_view(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(mask), JK, k))
    sets = torch.from_numpy(_reference_draw(mask, k).astype(np.int64))
    got = tinit.initialize_two_view(*_t(uv1, uv2, mask), TK, sets)
    assert bool(got.ok) == bool(want.ok) and bool(got.ok)
    assert bool(got.is_planar) == bool(want.is_planar) == (kind == "planar")
    np.testing.assert_allclose(got.R.numpy(), want.R, atol=1e-3)
    np.testing.assert_allclose(got.t.numpy(), want.t, atol=2e-3)
    g, w = got.good.numpy(), np.asarray(want.good)
    assert int((g != w).sum()) <= 0.01 * N_VALID
    assert abs(int(got.n_good) - int(want.n_good)) <= 0.01 * N_VALID
    np.testing.assert_allclose(got.points.numpy()[g & w], want.points[g & w], rtol=1e-3, atol=1e-2)
    # the truth, and no outlier among the good points
    np.testing.assert_allclose(got.R.numpy(), R, atol=5e-3)
    assert float(np.dot(got.t.numpy(), t)) > 0.99
    assert g[out].mean() < 0.05


def test_initialize_two_view_is_free_of_the_svd_signs(scene, monkeypatch):
    kind, (uv1, uv2, mask, *_rest) = scene
    sets = tinit.sample_hypotheses(torch.from_numpy(mask), torch.Generator().manual_seed(3))
    assert mask[sets.numpy()].all() and tuple(sets.shape) == (200, 8)
    base = tinit.initialize_two_view(*_t(uv1, uv2, mask), TK, sets)
    library_svd = tinit._library_svd
    flip = torch.tensor([-1.0, 1.0, -1.0])

    def flipped(A):
        U, s, Vh = library_svd(A)
        return U * flip, s, Vh * flip[:, None]

    monkeypatch.setattr(tinit, "_library_svd", flipped)
    U, s, Vh = tinit._svd(torch.from_numpy(np.diag([3.0, 2.0, 1.0]).astype(np.float32)))
    np.testing.assert_allclose((U * s) @ Vh, np.diag([3.0, 2.0, 1.0]), atol=1e-6)
    got = tinit.initialize_two_view(*_t(uv1, uv2, mask), TK, sets)
    assert bool(got.ok) and bool(base.ok)
    np.testing.assert_allclose(got.R.numpy(), base.R.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.t.numpy(), base.t.numpy(), atol=1e-5)
    np.testing.assert_array_equal(got.good.numpy(), base.good.numpy())
    assert int(got.n_good) == int(base.n_good) and bool(got.is_planar) == bool(base.is_planar)
    # the four motions of E, whatever the signs
    E = tinit._eight_point_E_weighted(*_t(*(tinit._normalize(torch.from_numpy(a), TK).numpy() for a in (uv1, uv2))),
                                      torch.from_numpy(mask.astype(np.float32)))
    Rf, tf = tinit._decompose_E(E)
    monkeypatch.setattr(tinit, "_library_svd", library_svd)
    Rb, tb = tinit._decompose_E(E)
    np.testing.assert_allclose(Rf.numpy(), Rb.numpy(), atol=1e-5)
    np.testing.assert_allclose(tf.numpy(), tb.numpy(), atol=1e-5)


BENCH_PAIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "bench_mono_init_pair.npz")
BENCH_K = (718.856, 718.856, 607.1928, 185.2157)  # SlamConfig()'s camera: fx, fy, cx, cy


def _fp64_refit(x1, x2, w, model):
    """The weighted refit in numpy float64: the smallest eigenvector of the
    weighted normal matrix (projected to an essential matrix for E)."""
    x1, x2, w = (np.asarray(a, np.float64) for a in (x1, x2, w))
    if model == "E":
        A = np.stack([x2[:, 0] * x1[:, 0], x2[:, 0] * x1[:, 1], x2[:, 0], x2[:, 1] * x1[:, 0], x2[:, 1] * x1[:, 1],
                      x2[:, 1], x1[:, 0], x1[:, 1], np.ones(len(x1))], -1) * w[:, None]
    else:
        xh = np.concatenate([x1, np.ones((len(x1), 1))], -1)
        z = np.zeros_like(xh)
        A = np.concatenate([np.concatenate([xh, z, -x2[:, 0:1] * xh], -1) * w[:, None],
                            np.concatenate([z, xh, -x2[:, 1:2] * xh], -1) * w[:, None]])
    M = np.linalg.eigh(A.T @ A)[1][:, 0].reshape(3, 3)
    if model == "E":
        U, _, Vt = np.linalg.svd(M)
        M = U @ np.diag([1.0, 1.0, 0.0]) @ Vt
    return M


def _sign_free(a, b):
    a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
    return min(np.abs(a - b).max(), np.abs(a + b).max())


def test_refits_on_the_bench_pair_are_float64_solutions():
    d = np.load(BENCH_PAIR)
    assert d["uv1"].shape == (2029, 2) and int(d["inliers_e"].sum()) == 1981
    K = TIntrinsics(*BENCH_K, 0.0)
    x1, x2 = (tinit._normalize(torch.from_numpy(d[k]), K).numpy() for k in ("uv1", "uv2"))
    for model, inl, jfn, tfn in (("E", d["inliers_e"], jinit._eight_point_E_weighted, tinit._eight_point_E_weighted),
                                 ("H", d["inliers_h"], jinit._dlt_H_weighted, tinit._dlt_H_weighted)):
        w = inl.astype(np.float32)
        got = tfn(*_t(x1, x2, w))
        assert got.dtype == torch.float32
        exact = _fp64_refit(x1, x2, w, model)
        want = np.asarray(jfn(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w)))
        assert _sign_free(got.numpy().astype(np.float64), exact) < 1e-6, model
        assert _sign_free(got.numpy(), want) < 2e-3, model
