"""Parity of the port's Sim3 operations with the reference (geometry/sim3.py):
the same seeded numpy inputs through both packages.

Tolerances: every group operation, `exp` and `log` within 1e-5 of the
reference (fp32 rounding of the same formulas; `log` solves its 3x3 system by
Cramer's rule where the reference factorises, which agrees to ~1e-6 on the
well-conditioned W matrix); the exp/log round trip within 2e-3, the bound of
the reference's own test. The tangents of `exp` and `log` are finite at zero
angle and zero log-scale, where every `where`-guarded branch meets its limit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_framework_tpu.geometry import se3 as jse3, sim3 as jsim3
from slam_framework_torch.geometry import se3 as tse3, sim3 as tsim3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; torch's default of one
    thread per core in each of them oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TOL = 1e-5


def _rand(seed, n=16, sigma_scale=0.3):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    t = rng.normal(size=(n, 3)).astype(np.float32)
    s = np.exp(rng.normal(size=(n,)).astype(np.float32) * sigma_scale)
    R = np.asarray(jse3.so3_exp(jnp.asarray(w)))
    return R, t, s


def _both(R, t, s):
    return (jsim3.make(jnp.asarray(R), jnp.asarray(t), jnp.asarray(s)),
            tsim3.make(torch.from_numpy(R), torch.from_numpy(t), torch.from_numpy(s)))


def _assert_same(got: dict, want: dict, tol=TOL):
    for k in ("R", "t", "s"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=tol, rtol=tol, err_msg=k)


def test_make_identity_and_se3_conversions():
    R, t, s = _rand(0)
    jS, tS = _both(R, t, s)
    _assert_same(tS, jS, 0)
    _assert_same(tsim3.identity((2, 3)), jsim3.identity((2, 3)), 0)
    np.testing.assert_allclose(tsim3.to_se3(tS).numpy(), np.asarray(jsim3.to_se3(jS)), atol=TOL)
    T = np.asarray(jsim3.to_se3(jS))
    _assert_same(tsim3.from_se3(torch.from_numpy(T)), jsim3.from_se3(jnp.asarray(T)), 0)


@pytest.mark.parametrize("op", ["compose", "inverse", "apply", "compose_inverse_is_identity"])
def test_group_operations_match_reference(op):
    jA, tA = _both(*_rand(1))
    jB, tB = _both(*_rand(2))
    if op == "compose":
        _assert_same(tsim3.compose(tA, tB), jsim3.compose(jA, jB))
    elif op == "inverse":
        _assert_same(tsim3.inverse(tA), jsim3.inverse(jA))
    elif op == "apply":
        pts = np.random.default_rng(3).normal(size=(16, 10, 3)).astype(np.float32)
        np.testing.assert_allclose(tsim3.apply(tA, torch.from_numpy(pts)).numpy(),
                                   np.asarray(jsim3.apply(jA, jnp.asarray(pts))), atol=TOL, rtol=TOL)
    else:
        I = tsim3.compose(tA, tsim3.inverse(tA))
        np.testing.assert_allclose(I["R"].numpy(), np.tile(np.eye(3), (16, 1, 1)), atol=1e-5)
        np.testing.assert_allclose(I["t"].numpy(), 0, atol=1e-4)
        np.testing.assert_allclose(I["s"].numpy(), 1, atol=1e-5)


def _tangents():
    """Generic tangents plus the rows where a Taylor branch is taken: zero,
    scale only, rotation only, tiny angle with a large scale, tiny scale."""
    v = (np.random.default_rng(4).normal(size=(32, 7)) * 0.4).astype(np.float32)
    v[0] = 0.0
    v[1] = [0, 0, 0, 0.3, -0.2, 0.1, 0.7]
    v[2] = [0.2, -0.1, 0.3, 0.5, 0.1, -0.4, 0.0]
    v[3] = [1e-7, -2e-7, 1e-7, 0.3, 0.2, 0.1, 0.5]
    v[4] = [0.3, 0.1, -0.2, 0.1, 0.2, 0.3, 1e-7]
    v[5] = [1e-7, 0, 0, 1.0, 2.0, 3.0, 1e-7]
    return v


def test_exp_and_log_match_reference_and_round_trip():
    v = _tangents()
    jS, tS = jsim3.exp(jnp.asarray(v)), tsim3.exp(torch.from_numpy(v))
    _assert_same(tS, jS)
    got = tsim3.log(tS).numpy()
    np.testing.assert_allclose(got, np.asarray(jsim3.log(jS)), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, v, atol=2e-3)
    # the log of the reference's Sim3s, too (not only of the port's own)
    R, t, s = _rand(5, n=32)
    jS, tS = _both(R, t, s)
    np.testing.assert_allclose(tsim3.log(tS).numpy(), np.asarray(jsim3.log(jS)), atol=TOL, rtol=TOL)


def test_tangents_finite_at_the_identity():
    z = torch.zeros((1, 7))  # batched, as every caller in the port differentiates it

    def through(v):
        S = tsim3.exp(v)
        return torch.cat([S["R"].reshape(-1), S["t"][0], S["s"], tsim3.log(S)[0]])

    J = torch.func.jacfwd(through)(z)[:, 0]
    assert J.shape == (20, 7) and J.dtype == torch.float32 and bool(torch.isfinite(J).all())
    # d log(exp(v)) / dv = I at v = 0
    np.testing.assert_allclose(J[13:].numpy(), np.eye(7), atol=1e-6)
    Jlog = torch.func.jacfwd(tse3.so3_log)(torch.eye(3)[None])
    assert bool(torch.isfinite(Jlog).all())
