"""Sim3 essential-graph (pose-graph) optimisation: batched Gauss-Newton.

Port of slam_framework_tpu/optim/pose_graph.py, after
Optimizer::OptimizeEssentialGraph (optimizer.cpp:718-960): Sim3 vertices
joined by Sim3 edges (spanning tree, strong covisibility, loop edges),
optimised after a loop closure.

  - Vertices are Sim3 world->camera transforms as struct-of-arrays
    (R: (V,3,3), t: (V,3), s: (V,)) with a validity mask; fixed vertices (the
    loop keyframe) are masked out of the update.
  - Edges are a flat table (i, j, measurement S_ji, mask). An edge's residual
    is r = log(S_ji . S_iw . S_jw^-1) in R^7, zero when the relative pose
    matches the measurement.
  - One Gauss-Newton step: per-edge 7x7 Jacobians with respect to the
    left-multiplicative tangent updates of both endpoints by forward-mode
    differentiation (`torch.func.jvp`, one unit tangent through every edge at
    once), then a block-Jacobi preconditioned conjugate gradient on the
    normal equations, matrix-free: the Hessian-vector product is two gathers
    and two per-vertex sums over the edge table.
  - Fixed iteration counts, accept/reject by `torch.where`: no value is read
    back to the host.

The per-vertex sums are products with a (V, E) one-hot matrix, never a
scatter-add: on a GPU a scatter-add is made of atomics whose order changes
from run to run, and the step is accepted on a comparison of two costs that
is sensitive to the order of summation. Two runs give the same bits.

The distributed layer (parallel/dist_pose_graph.py) runs `optimize` on each
rank's block of edges, its `allreduce=` hook summing the edge-indexed sums over
the ranks.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from slam_framework_torch.geometry import sim3


class PoseGraphProblem(NamedTuple):
    """Fixed-capacity Sim3 pose graph. V vertex slots, E edge slots."""

    v_R: torch.Tensor       # (V, 3, 3) rotation of S_iw
    v_t: torch.Tensor       # (V, 3)
    v_s: torch.Tensor       # (V,)
    v_fixed: torch.Tensor   # (V,) bool — not updated (loop keyframe / invalid slots)
    v_mask: torch.Tensor    # (V,) bool — valid vertex
    e_i: torch.Tensor       # (E,) int32 — "from" vertex
    e_j: torch.Tensor       # (E,) int32 — "to" vertex
    e_R: torch.Tensor       # (E, 3, 3) measurement S_ji = S_jw . S_iw^-1
    e_t: torch.Tensor       # (E, 3)
    e_s: torch.Tensor       # (E,)
    e_mask: torch.Tensor    # (E,) bool
    e_weight: torch.Tensor  # (E,) f32 — information scale (1.0 = reference behaviour)


class PoseGraphResult(NamedTuple):
    v_R: torch.Tensor
    v_t: torch.Tensor
    v_s: torch.Tensor
    final_cost: torch.Tensor
    initial_cost: torch.Tensor  # cost at the problem's vertices, before the first step


def _s(R, t, s) -> dict:
    return {"R": R, "t": t, "s": s}


def edge_residuals(Si: dict, Sj: dict, Sji: dict) -> torch.Tensor:
    """(E, 7) residuals r = log(S_ji . S_iw . S_jw^-1) of (E,)-batched Sim3s."""
    return sim3.log(sim3.compose(Sji, sim3.compose(Si, sim3.inverse(Sj))))


def edge_res_jac(Si: dict, Sj: dict, Sji: dict):
    """Residuals (E, 7) at zero update and the Jacobians (E, 7, 7) x 2 with
    respect to the left-multiplicative tangents of both endpoints,
    r(di, dj) = log(S_ji . exp(di) S_iw . (exp(dj) S_jw)^-1).

    The edges are independent, so the 14 columns come from 14 forward-mode
    derivatives of the batched residual, each pushing one unit tangent through
    every edge at once (`torch.func.jvp` under `vmap` over the 14 directions)."""
    E = Si["s"].shape[0]
    dtype, dev = Si["R"].dtype, Si["R"].device

    def residual(d):  # (E, 14) -> (E, 7)
        Si2 = sim3.compose(sim3.exp(d[:, :7]), Si)
        Sj2 = sim3.compose(sim3.exp(d[:, 7:]), Sj)
        return edge_residuals(Si2, Sj2, Sji)

    zero = torch.zeros((E, 14), dtype=dtype, device=dev)
    basis = torch.eye(14, dtype=dtype, device=dev)[:, None, :].expand(14, E, 14)
    r, cols = torch.func.vmap(lambda tan: torch.func.jvp(residual, (zero,), (tan,)), out_dims=(None, 0))(basis)
    J = cols.permute(1, 2, 0)  # (E, 7, 14)
    return r, J[:, :, :7], J[:, :, 7:]


def _identity(x):
    return x


def _pcg_block(hvp, g, Minv, iters: int):
    """CG with a block-diagonal preconditioner. g, x: (V, 7); Minv: (V, 7, 7)."""

    def prec(r):
        return torch.einsum("vij,vj->vi", Minv, r)

    x = torch.zeros_like(g)
    r = g
    z = prec(r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(iters):
        Ap = hvp(p)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.clamp(rz, min=1e-20)
        p = z + beta * p
        rz = rz_new
    return x


def optimize(prob: PoseGraphProblem, iters: int = 20, cg_iters: int = 60, damping: float = 1e-6,
             allreduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> PoseGraphResult:
    """Gauss-Newton over the Sim3 pose graph (20 iterations with identity
    information, as optimizer.cpp:718-960; GN with a tiny damping, the graph
    being anchored by the fixed loop keyframe). iters >= 1.

    allreduce: None for the whole graph on one device. Set, the edge table is
    one rank's shard (parallel/dist_pose_graph.py) and every edge-indexed sum
    (cost, gradient, block diagonal, Hessian-vector product) is passed through
    it (`RankMesh.all_reduce_sum`) where the reference psums over its
    `axis_name`: the vertex state stays replicated on every rank."""
    red = allreduce if allreduce is not None else _identity
    V = prob.v_R.shape[0]
    dev, f32 = prob.v_R.device, torch.float32
    free = (~prob.v_fixed) & prob.v_mask
    free_f = free.to(f32)[:, None]  # (V, 1)
    ew = prob.e_mask.to(f32) * prob.e_weight
    ei = torch.clamp(prob.e_i.long(), 0, V - 1)
    ej = torch.clamp(prob.e_j.long(), 0, V - 1)
    verts = torch.arange(V, device=dev)
    # per-vertex sums over the edge table: (V, E) one-hot products; an index
    # outside [0, V) matches no vertex and is dropped
    onehot_i = (prob.e_i.long()[None, :] == verts[:, None]).to(f32)
    onehot_j = (prob.e_j.long()[None, :] == verts[:, None]).to(f32)
    eye7 = torch.eye(7, dtype=f32, device=dev)
    Sji = _s(prob.e_R, prob.e_t, prob.e_s)

    def per_vertex(at_i, at_j):
        flat_i, flat_j = at_i.reshape(at_i.shape[0], -1), at_j.reshape(at_j.shape[0], -1)
        return (torch.matmul(onehot_i, flat_i) + torch.matmul(onehot_j, flat_j)).reshape((V,) + at_i.shape[1:])

    R, t, s = prob.v_R, prob.v_t, prob.v_s
    initial_cost = final_cost = None
    for _ in range(iters):
        Si = _s(R[ei], t[ei], s[ei])
        Sj = _s(R[ej], t[ej], s[ej])
        r, Ji, Jj = edge_res_jac(Si, Sj, Sji)  # (E,7), (E,7,7), (E,7,7)
        r = r * ew[:, None]
        cost = red(torch.sum(r * r))
        if initial_cost is None:
            initial_cost = cost

        # gradient: g[v] = sum_e J^T r over the edges at v
        gi = torch.einsum("eij,ei->ej", Ji, r) * ew[:, None]
        gj = torch.einsum("eij,ei->ej", Jj, r) * ew[:, None]
        g = red(per_vertex(gi, gj)) * free_f

        # block diagonal of H, for the preconditioner
        Hi = torch.einsum("eij,eik->ejk", Ji, Ji) * ew[:, None, None]
        Hj = torch.einsum("eij,eik->ejk", Jj, Jj) * ew[:, None, None]
        Minv = torch.linalg.inv_ex(red(per_vertex(Hi, Hj)) + 1e-6 * eye7)[0]

        def hvp(v):
            u = (torch.einsum("eij,ej->ei", Ji, v[ei]) + torch.einsum("eij,ej->ei", Jj, v[ej])) * ew[:, None]
            out = red(per_vertex(torch.einsum("eij,ei->ej", Ji, u), torch.einsum("eij,ei->ej", Jj, u)))
            return out * free_f + damping * v

        dx = -_pcg_block(hvp, g, Minv, cg_iters) * free_f

        # left-multiplicative update; fixed vertices stay verbatim
        Snew = sim3.compose(sim3.exp(dx), _s(R, t, s))
        R2 = torch.where(free[:, None, None], Snew["R"], R)
        t2 = torch.where(free[:, None], Snew["t"], t)
        s2 = torch.where(free, Snew["s"], s)

        r2 = edge_residuals(_s(R2[ei], t2[ei], s2[ei]), _s(R2[ej], t2[ej], s2[ej]), Sji) * ew[:, None]
        cost2 = red(torch.sum(r2 * r2))
        # accept with a small RELATIVE tolerance: a strict `<` is sensitive to
        # the rounding of the two sums
        better = cost2 < cost * (1.0 + 1e-6)
        R = torch.where(better, R2, R)
        t = torch.where(better, t2, t)
        s = torch.where(better, s2, s)
        final_cost = torch.where(better, cost2, cost)
    return PoseGraphResult(v_R=R, v_t=t, v_s=s, final_cost=final_cost, initial_cost=initial_cost)
