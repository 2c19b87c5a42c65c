"""Distributed Sim3 essential-graph optimisation over a rank mesh.

Port of slam_framework_tpu/parallel/dist_pose_graph.py, after
Optimizer::OptimizeEssentialGraph (optimizer.cpp:718-960). A pose graph after
a loop closure at city scale has 1e4-1e5 edges, and the per-edge Jacobians
dominate. Layout (the recipe of parallel/dist_ba.py):

  - EDGES are dealt round-robin over the ranks, each holding E/D edge slots
    (padded with masked slots to equal size);
  - the VERTEX state (R, t, s, masks) is replicated: every edge-indexed sum
    inside `optim/pose_graph.optimize` (gradient, block-Jacobi diagonal,
    Hessian-vector product, costs) goes through `allreduce=`, so every rank
    steps the same vertex state. The payload per CG iteration is one (V, 7).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from slam_framework_torch.optim import pose_graph
from slam_framework_torch.optim.pose_graph import PoseGraphProblem, PoseGraphResult
from slam_framework_torch.parallel.dist_ba import host
from slam_framework_torch.parallel.mesh import RankMesh

VERTEX_FIELDS = ("v_R", "v_t", "v_s", "v_fixed", "v_mask")


def shard_problem(prob: PoseGraphProblem, n_shards: int, device=None) -> PoseGraphProblem:
    """Deal the live edges round-robin into n_shards equal blocks (edge at live
    rank r -> shard r % D, slot r // D) and return a problem, on `device`,
    whose edge arrays are the concatenation of the blocks. Vertex arrays pass
    through. Pad slots carry IDENTITY rotations (the loop closer's own padded
    edge tables do): a zero 3x3 is no rotation, masked or not."""
    e_mask = host(prob.e_mask)
    live = np.nonzero(e_mask)[0]
    D = n_shards
    per = max(int(np.ceil(len(live) / D)), 1)
    E_s = D * per
    ranks = np.arange(len(live))
    slot = (ranks % D) * per + ranks // D

    def deal(src, fill):
        src = host(src)
        out = np.full((E_s,) + src.shape[1:], fill, src.dtype)
        out[slot] = src[live]
        return out

    e_R = deal(prob.e_R, 0.0)
    filled = np.zeros(E_s, bool)
    filled[slot] = True
    e_R[~filled] = np.eye(3, dtype=e_R.dtype)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return PoseGraphProblem(
        **{name: put(host(getattr(prob, name))) for name in VERTEX_FIELDS},
        e_i=put(deal(prob.e_i, 0)),
        e_j=put(deal(prob.e_j, 0)),
        e_R=put(e_R),
        e_t=put(deal(prob.e_t, 0.0)),
        e_s=put(deal(prob.e_s, 1.0)),
        e_mask=put(deal(e_mask, False)),
        e_weight=put(deal(prob.e_weight, 0.0)),
    )


def optimize_ranks(sharded: PoseGraphProblem, mesh: RankMesh, iters: int = 20, cg_iters: int = 60,
                   damping: float = 1e-6) -> List[PoseGraphResult]:
    """`pose_graph.optimize` as one SPMD program over the mesh: one (replicated)
    result per rank of `mesh.ranks`."""

    def body(rank: int) -> PoseGraphResult:
        p = PoseGraphProblem(**{
            name: (getattr(sharded, name).to(mesh.device) if name in VERTEX_FIELDS
                   else mesh.block(getattr(sharded, name), rank))
            for name in PoseGraphProblem._fields
        })
        return pose_graph.optimize(p, iters=iters, cg_iters=cg_iters, damping=damping,
                                   allreduce=mesh.all_reduce_sum)

    return mesh.run(body)


def optimize_sharded(sharded: PoseGraphProblem, mesh: RankMesh, iters: int = 20, cg_iters: int = 60,
                     damping: float = 1e-6) -> PoseGraphResult:
    """The replicated result of `optimize_ranks` (the first rank this process runs)."""
    return optimize_ranks(sharded, mesh, iters, cg_iters, damping)[0]
