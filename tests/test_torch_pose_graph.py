"""Parity of the port's Sim3 pose graph with the reference (optim/pose_graph.py)
on the five scenes of tests/test_pose_graph.py: the same seeded problem goes
through `optimize` in both packages.

Tolerances: edge residuals within 1e-5 and both 7x7 edge Jacobians within 1e-4
of `jax.jacfwd`'s (the same formulas differentiated forward in both packages),
on drifted edges AND on identity edges (rel = I, where every guarded branch of
so3_log / sim3.exp / sim3.log sits at its limit); optimised camera centres
within 1e-3 m of the reference's, scales within 1e-3, final cost within 1% (or
1e-7 absolute where it is ~0); the fixed vertex bit-unchanged; each scene also
meets the bound its reference test sets. The port sums per vertex with one-hot
products where the reference scatters, so iterates differ by fp32 rounding; the
accept test has a relative tolerance so no step flips. Two runs are bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_framework_tpu.optim import pose_graph as jpg
from slam_framework_torch import interop
from slam_framework_torch.optim import pose_graph as tpg
from test_pose_graph import _build_problem, _pose_errors


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; torch's default of one
    thread per core in each of them oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _padded(prob, V=16, pad_v=8, pad_e=8):
    rng = np.random.default_rng(1)
    return jpg.PoseGraphProblem(
        v_R=jnp.concatenate([prob.v_R, jnp.tile(jnp.eye(3), (pad_v, 1, 1))]),
        v_t=jnp.concatenate([prob.v_t, jnp.asarray(rng.normal(0, 1, (pad_v, 3)), dtype=jnp.float32)]),
        v_s=jnp.concatenate([prob.v_s, jnp.ones(pad_v)]),
        v_fixed=jnp.concatenate([prob.v_fixed, jnp.ones(pad_v, bool)]),
        v_mask=jnp.concatenate([prob.v_mask, jnp.zeros(pad_v, bool)]),
        e_i=jnp.concatenate([prob.e_i, jnp.full(pad_e, V, jnp.int32)]),
        e_j=jnp.concatenate([prob.e_j, jnp.full(pad_e, V + 1, jnp.int32)]),
        e_R=jnp.concatenate([prob.e_R, jnp.tile(jnp.eye(3), (pad_e, 1, 1))]),
        e_t=jnp.concatenate([prob.e_t, jnp.asarray(rng.normal(0, 1, (pad_e, 3)), dtype=jnp.float32)]),
        e_s=jnp.concatenate([prob.e_s, jnp.ones(pad_e)]),
        e_mask=jnp.concatenate([prob.e_mask, jnp.zeros(pad_e, bool)]),
        e_weight=jnp.concatenate([prob.e_weight, jnp.ones(pad_e)]),
    )


def _scene(name):
    if name == "consistent_graph_zero_residual":
        prob, gt, est = _build_problem(16, drift_rot=0.0, drift_trans=0.0)
        return prob._replace(v_R=jnp.asarray(gt[:, :3, :3]), v_t=jnp.asarray(gt[:, :3, 3])), gt, 3, 16
    if name == "corrects_accumulated_drift":
        return _build_problem(32, drift_rot=0.01, drift_trans=0.05)[:2] + (20, 32)
    if name == "scale_drift_corrected":
        return _build_problem(24, drift_rot=0.005, drift_trans=0.02, drift_scale=0.05)[:2] + (20, 24)
    if name == "fixed_vertex_untouched":
        return _build_problem(12, drift_rot=0.01, drift_trans=0.03)[:2] + (10, 12)
    prob, gt, _ = _build_problem(16, drift_rot=0.01, drift_trans=0.03)
    return _padded(prob), gt, 20, 16


SCENES = ["consistent_graph_zero_residual", "corrects_accumulated_drift", "scale_drift_corrected",
          "fixed_vertex_untouched", "masked_edges_and_vertices_ignored"]
_cache = {}


def _run(name):
    if name not in _cache:
        prob, gt, iters, n = _scene(name)
        want = jpg.optimize(prob, iters=iters)
        got = tpg.optimize(interop.pose_graph_problem(prob, "cpu"), iters=iters)
        _cache[name] = (prob, gt, n, want, got)
    return _cache[name]


@pytest.mark.parametrize("name", SCENES)
def test_vertices_and_cost_match_reference(name):
    prob, gt, n, want, got = _run(name)
    e_got = _pose_errors(got.v_R.numpy()[:n], got.v_t.numpy()[:n], got.v_s.numpy()[:n], gt)
    e_want = _pose_errors(np.asarray(want.v_R)[:n], np.asarray(want.v_t)[:n], np.asarray(want.v_s)[:n], gt)
    T_got = interop.to_numpy(tpg.sim3.to_se3({"R": got.v_R, "t": got.v_t, "s": got.v_s}))[:n]
    T_want = np.asarray(jpg.sim3.to_se3({"R": want.v_R, "t": want.v_t, "s": want.v_s}))[:n]
    c_got = -np.einsum("nji,nj->ni", T_got[:, :3, :3], T_got[:, :3, 3])
    c_want = -np.einsum("nji,nj->ni", T_want[:, :3, :3], T_want[:, :3, 3])
    assert np.linalg.norm(c_got - c_want, axis=1).max() < 1e-3
    np.testing.assert_allclose(got.v_s.numpy()[:n], np.asarray(want.v_s)[:n], atol=1e-3)
    assert float(got.final_cost) == pytest.approx(float(want.final_cost), rel=0.01, abs=1e-7)
    # the bound of the reference's own test of this scene
    bound = {"consistent_graph_zero_residual": 1e-4, "scale_drift_corrected": 0.15,
             "masked_edges_and_vertices_ignored": 0.1}.get(name)
    if bound is not None:
        assert e_got.max() < bound and e_want.max() < bound
    if name == "consistent_graph_zero_residual":
        assert float(got.final_cost) < 1e-8 and bool(torch.isfinite(got.v_t).all())
    if name == "corrects_accumulated_drift":
        e0 = _pose_errors(prob.v_R, prob.v_t, prob.v_s, gt)
        assert e0.max() > 0.1 and e_got.max() < e0.max() * 0.05 and float(got.final_cost) < 1e-4
        assert float(got.initial_cost) > 100 * float(got.final_cost)
    if name == "scale_drift_corrected":
        np.testing.assert_allclose(got.v_s.numpy(), 1.0, atol=0.02)


@pytest.mark.parametrize("name", SCENES)
def test_fixed_vertices_bit_unchanged(name):
    prob, _, _, _, got = _run(name)
    fixed = np.asarray(prob.v_fixed)
    np.testing.assert_array_equal(got.v_R.numpy()[fixed], np.asarray(prob.v_R)[fixed])
    np.testing.assert_array_equal(got.v_t.numpy()[fixed], np.asarray(prob.v_t)[fixed])
    np.testing.assert_array_equal(got.v_s.numpy()[fixed], np.asarray(prob.v_s)[fixed])


@pytest.mark.parametrize("name", ["consistent_graph_zero_residual", "scale_drift_corrected"])
def test_edge_residuals_and_jacobians_match_jacfwd(name):
    """The identity edge (a consistent graph: rel = I on every edge) and drifted edges."""
    prob = _scene(name)[0]
    Sv = {"R": prob.v_R, "t": prob.v_t, "s": prob.v_s}
    Si = jax.tree.map(lambda a: a[prob.e_i], Sv)
    Sj = jax.tree.map(lambda a: a[prob.e_j], Sv)
    Sji = {"R": prob.e_R, "t": prob.e_t, "s": prob.e_s}
    r, Ji, Jj = jax.vmap(jpg._edge_res_jac)(Si, Sj, Sji)
    tS = [{k: interop.to_tensor(v) for k, v in S.items()} for S in (Si, Sj, Sji)]
    tr, tJi, tJj = tpg.edge_res_jac(*tS)
    assert tJi.dtype == torch.float32 and bool(torch.isfinite(tJi).all()) and bool(torch.isfinite(tJj).all())
    np.testing.assert_allclose(tr.numpy(), np.asarray(r), atol=1e-5)
    np.testing.assert_allclose(tJi.numpy(), np.asarray(Ji), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tJj.numpy(), np.asarray(Jj), atol=1e-4, rtol=1e-4)
    if name == "consistent_graph_zero_residual":
        assert np.abs(np.asarray(r)).max() < 1e-5  # rel = I on every edge


def test_two_runs_bit_equal():
    prob = interop.pose_graph_problem(_scene("corrects_accumulated_drift")[0], "cpu")
    a, b = tpg.optimize(prob, iters=5), tpg.optimize(prob, iters=5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
