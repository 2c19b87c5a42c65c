"""Parity of the port's batched DLT triangulation with the reference
(geometry/triangulation.py): the same seeded two-view scene goes through
`triangulate_dlt`, `reprojection_error` and `parallax_cosine` in both packages.

Tolerance: rtol 1e-4 (atol 1e-4 of a metre / a squared pixel / a cosine). Both
sides run the same three Householder reflections in fp32; only the order of the
four-term sums differs, and XLA may fuse a multiply-add.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_framework_tpu.geometry import triangulation as jtri
from slam_framework_torch.geometry import triangulation as ttri

FX, FY, CX, CY = 500.0, 500.0, 320.0, 240.0
KM = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1.0]], np.float32)


def _scene(seed, batch, n=200, noise=0.3):
    """`batch` camera pairs (() for one pair): P1, P2 (..., 3, 4), pixels (..., n, 2),
    camera centres (..., 3), true points (..., n, 3)."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-8, 8, batch + (n,)), rng.uniform(-4, 4, batch + (n,)),
                    rng.uniform(6, 30, batch + (n,))], -1).astype(np.float32)

    def cam(shift):
        T = np.zeros(batch + (3, 4), np.float32)
        T[..., :3, :3] = np.eye(3)
        w = rng.normal(0, 0.01, batch + (3,)).astype(np.float32)
        T[..., 0, 1], T[..., 1, 0] = -w[..., 2], w[..., 2]   # a small rotation, first order
        T[..., 0, 2], T[..., 2, 0] = w[..., 1], -w[..., 1]
        T[..., :3, 3] = rng.normal(0, 0.05, batch + (3,)) + np.array([-shift, 0.0, 0.0])
        return T

    T1, T2 = cam(0.0), cam(1.0)

    def project(T):
        pc = np.einsum("...ij,...nj->...ni", T[..., :3, :3], pts) + T[..., None, :3, 3]
        uv = np.stack([FX * pc[..., 0] / pc[..., 2] + CX, FY * pc[..., 1] / pc[..., 2] + CY], -1)
        return (uv + rng.normal(0, noise, uv.shape)).astype(np.float32)

    def centre(T):
        return -np.einsum("...ji,...j->...i", T[..., :3, :3], T[..., :3, 3])

    return dict(P1=KM @ T1, P2=KM @ T2, uv1=project(T1), uv2=project(T2), c1=centre(T1), c2=centre(T2), pts=pts)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


BATCHES = [pytest.param((), id="one_pair"), pytest.param((10,), id="ten_neighbours")]


@pytest.mark.parametrize("batch", BATCHES)
def test_triangulate_dlt_matches_reference(batch):
    s = _scene(1, batch)
    args = (s["P1"], s["P2"], s["uv1"], s["uv2"])
    want = np.asarray(jtri.triangulate_dlt(*_j(*args)))
    got = ttri.triangulate_dlt(*_t(*args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # and both recover the scene: 0.3 px of noise at 6-30 m with a 1 m baseline
    assert np.median(np.linalg.norm(got - s["pts"], axis=-1)) < 0.5


@pytest.mark.parametrize("batch", BATCHES)
def test_reprojection_error_matches_reference(batch):
    s = _scene(2, batch)
    pts = s["pts"] + np.random.default_rng(3).normal(0, 0.05, s["pts"].shape).astype(np.float32)
    want_e, want_z = jtri.reprojection_error(*_j(s["P2"], pts, s["uv2"]))
    got_e, got_z = ttri.reprojection_error(*_t(s["P2"], pts, s["uv2"]))
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_z.numpy(), np.asarray(want_z), rtol=1e-4, atol=1e-4)
    assert (got_z.numpy() > 0).all() and got_e.shape == batch + (200,)


@pytest.mark.parametrize("batch", BATCHES)
def test_parallax_cosine_matches_reference(batch):
    s = _scene(4, batch)
    want = np.asarray(jtri.parallax_cosine(*_j(s["c1"], s["c2"], s["pts"])))
    got = ttri.parallax_cosine(*_t(s["c1"], s["c2"], s["pts"])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert got.min() > 0.9 and got.max() < 1.0


def test_triangulate_dlt_broadcasts_one_projection_against_many():
    """The mapper triangulates one keyframe against stacked neighbours: an
    expanded (not copied) P1 gives what a loop over the neighbours gives."""
    s = _scene(5, (4,))
    P1 = s["P1"][0]
    uv1 = s["uv1"][0]
    P1t, P2t, uv1t, uv2t = _t(P1, s["P2"], uv1, s["uv2"])
    got = ttri.triangulate_dlt(P1t.expand(P2t.shape), P2t, uv1t.expand(uv2t.shape), uv2t)
    for n in range(4):
        want = ttri.triangulate_dlt(P1t, P2t[n], uv1t, uv2t[n])
        np.testing.assert_array_equal(got[n].numpy(), want.numpy())
