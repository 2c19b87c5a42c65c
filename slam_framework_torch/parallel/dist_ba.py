"""Distributed Schur-complement bundle adjustment over a rank mesh.

Port of slam_framework_tpu/parallel/dist_ba.py. The BA problem's landmark and
observation tensors are sharded over the ranks of a mesh (parallel/mesh.py)
and the camera system is reduced across them:

  - partition: points are dealt to ranks TOGETHER WITH all their observations,
    so a point's normal-equation block and Schur contribution are rank-local;
  - cameras are replicated: the (C, 6) CG state and (C, 6, 6) preconditioner
    are the same on every rank, kept so by summing the ranks' partial camera
    sums (`optim/global_ba.optimize_global(allreduce=)`: 4 sums of at most
    C x 27 floats and 2 scalars per LM iteration, one (C, 6) sum per CG
    iteration, one scalar at the end: the reduced camera system, never the raw
    observations);
  - every rank runs the unchanged `optimize_global` on its block (`mesh.run`).

The layouts (`point_layout`, `shard_problem`) are host numpy, equal array for
array to the reference's.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from slam_framework_torch.geometry.projection import Intrinsics
from slam_framework_torch.optim import global_ba
from slam_framework_torch.optim.global_ba import GlobalBAProblem, GlobalBAResult, _next_pow2
from slam_framework_torch.parallel.mesh import RankMesh

# fields of a GlobalBAProblem that are replicated on every rank; the others are
# shard-concatenated along axis 0
REPLICATED = ("cam_pose", "cam_fixed", "cam_mask")


def host(a) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def point_layout(n_live: int, n_shards: int, owner=None):
    """Shard layout of live points: (s_of, lp_of, P_s), the shard id and local
    slot per live-point rank and the (pow2) per-shard capacity.

    owner=None: round-robin deal (rank r -> shard r % D, slot r // D).
    owner=(n_live,) int array: OWNER-KEYED deal (map-block sharding, each point
    on the shard owning its covisibility segment, parallel/map_shard.py);
    slots are assigned in rank order within each shard."""
    D = n_shards
    ranks = np.arange(n_live, dtype=np.int64)
    if owner is None:
        s_of = ranks % D
        lp_of = ranks // D
        P_s = _next_pow2(max(int(np.ceil(n_live / D)) if n_live else 1, 1))
    else:
        s_of = np.asarray(owner, np.int64)
        # cumcount within each shard, in rank order
        order = np.argsort(s_of, kind="stable")
        so = s_of[order]
        new = np.r_[True, so[1:] != so[:-1]] if n_live else np.zeros(0, bool)
        idx = np.arange(n_live, dtype=np.int64)
        start = np.maximum.accumulate(np.where(new, idx, 0)) if n_live else idx
        lp_of = np.empty(n_live, np.int64)
        lp_of[order] = idx - start
        counts = np.bincount(s_of, minlength=D) if n_live else np.zeros(D, np.int64)
        P_s = _next_pow2(max(int(counts.max()) if n_live else 1, 1))
    return s_of, lp_of, P_s


def shard_problem(prob: GlobalBAProblem, n_shards: int, owner: Optional[np.ndarray] = None,
                  device=None) -> GlobalBAProblem:
    """Repartition a problem into n_shards equal blocks, on `device`.

    Points are dealt round-robin by default (balances observation counts where
    the map's density varies along the trajectory); `owner` (per LIVE point,
    in rank order) deals them by covisibility segment. Each point carries its
    observations, point-major within the shard. Point and observation arrays
    are the concatenation of the shard blocks; cam_obs_slots is (D, C, Oc_s);
    the camera arrays pass through."""
    pt_mask = host(prob.pt_mask)
    obs_mask = host(prob.obs_mask)
    obs_cam = host(prob.obs_cam)
    pt_slots = host(prob.pt_obs_slots)
    C = prob.cam_pose.shape[0]
    O = pt_slots.shape[1]
    D = n_shards

    # the point at live rank r goes to shard s_of[r], local slot lp_of[r]
    pids = np.nonzero(pt_mask)[0]
    Np = len(pids)
    ranks = np.arange(Np, dtype=np.int64)
    s_of, lp_of, P_s = point_layout(Np, D, owner)

    slots = pt_slots[pids]                                   # (Np, O)
    valid = (slots >= 0) & obs_mask[np.maximum(slots, 0)]
    flat_sel = valid.reshape(-1)
    e_rank = np.broadcast_to(ranks[:, None], (Np, O)).reshape(-1)[flat_sel]
    e_o = slots.reshape(-1)[flat_sel]                        # source observation
    e_s = s_of[e_rank]
    # a stable sort by shard keeps (point rank, slot) order within each shard
    order = np.argsort(e_s, kind="stable")
    e_rank, e_o, e_s = e_rank[order], e_o[order], e_s[order]
    e_lp = lp_of[e_rank]
    shard_counts = np.bincount(e_s, minlength=D)
    M_s = _next_pow2(max(int(shard_counts.max()) if len(e_s) else 1, 1))
    starts = np.concatenate([[0], np.cumsum(shard_counts)[:-1]])
    mi = np.arange(len(e_s), dtype=np.int64) - np.repeat(starts, shard_counts)  # local observation

    s_pt_pos = np.zeros((D * P_s, 3), np.float32)
    s_pt_mask = np.zeros(D * P_s, bool)
    s_obs_cam = np.zeros(D * M_s, np.int32)
    s_obs_pt = np.zeros(D * M_s, np.int32)
    s_obs_uv = np.zeros((D * M_s, 2), np.float32)
    s_obs_ur = np.full(D * M_s, -1.0, np.float32)
    s_obs_w = np.ones(D * M_s, np.float32)
    s_obs_mask = np.zeros(D * M_s, bool)
    s_pt_slots = np.full((D * P_s, O), -1, np.int32)

    s_pt_pos[s_of * P_s + lp_of] = host(prob.pt_pos)[pids]
    s_pt_mask[s_of * P_s + lp_of] = True

    gm = e_s * M_s + mi
    camv = obs_cam[e_o]
    s_obs_cam[gm] = camv
    s_obs_pt[gm] = e_lp
    s_obs_uv[gm] = host(prob.obs_uv)[e_o]
    s_obs_ur[gm] = host(prob.obs_ur)[e_o]
    s_obs_w[gm] = host(prob.obs_inv_sigma2)[e_o]
    s_obs_mask[gm] = True

    if len(e_s):
        # per-point slot lists: one point's entries are contiguous, so the slot
        # is mi minus the point's first mi
        idx = np.arange(len(e_s), dtype=np.int64)
        new_pt = np.r_[True, e_rank[1:] != e_rank[:-1]]
        start_idx = np.maximum.accumulate(np.where(new_pt, idx, 0))
        s_pt_slots[e_s * P_s + e_lp, mi - mi[start_idx]] = mi

        # per-(shard, camera) slot lists: cumcount within the group, mi order kept
        gkey = e_s * C + camv
        ord2 = np.argsort(gkey, kind="stable")
        gk2 = gkey[ord2]
        new2 = np.r_[True, gk2[1:] != gk2[:-1]]
        start2 = np.maximum.accumulate(np.where(new2, np.arange(len(gk2), dtype=np.int64), 0))
        fc = np.arange(len(gk2), dtype=np.int64) - start2
        Oc_s = _next_pow2(int(fc.max()) + 1 if len(fc) else 1)
        s_cam_slots = np.full((D, C, Oc_s), -1, np.int32)
        s_cam_slots[e_s[ord2], camv[ord2], fc] = mi[ord2]
    else:
        s_cam_slots = np.full((D, C, 1), -1, np.int32)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return GlobalBAProblem(
        cam_pose=put(host(prob.cam_pose)),
        cam_fixed=put(host(prob.cam_fixed)),
        cam_mask=put(host(prob.cam_mask)),
        pt_pos=put(s_pt_pos),
        pt_mask=put(s_pt_mask),
        obs_cam=put(s_obs_cam),
        obs_pt=put(s_obs_pt),
        obs_uv=put(s_obs_uv),
        obs_ur=put(s_obs_ur),
        obs_inv_sigma2=put(s_obs_w),
        obs_mask=put(s_obs_mask),
        pt_obs_slots=put(s_pt_slots),
        cam_obs_slots=put(s_cam_slots),
    )


def rank_problem(sharded: GlobalBAProblem, mesh: RankMesh, rank: int) -> GlobalBAProblem:
    """What rank `rank` holds of a sharded problem: the replicated cameras and
    its block of everything else, on the mesh's device."""
    return GlobalBAProblem(**{
        name: (getattr(sharded, name).to(mesh.device) if name in REPLICATED
               else mesh.block(getattr(sharded, name), rank))
        for name in GlobalBAProblem._fields
    })._replace(cam_obs_slots=mesh.block(sharded.cam_obs_slots, rank)[0])


def optimize_global_ranks(
    sharded: GlobalBAProblem,
    mesh: RankMesh,
    K: Intrinsics,
    iters_first: int = 5,
    iters_second: int = 10,
    cg_iters: int = 60,
    lam0: float = 1e-4,
) -> List[GlobalBAResult]:
    """`optimize_global` as one SPMD program over the mesh: one result per rank
    of `mesh.ranks`. `sharded` comes from shard_problem with n_shards == mesh
    size. Nothing is read back to the host."""

    def body(rank: int) -> GlobalBAResult:
        return global_ba.optimize_global(
            rank_problem(sharded, mesh, rank), K=K, iters_first=iters_first, iters_second=iters_second,
            cg_iters=cg_iters, lam0=lam0, allreduce=mesh.all_reduce_sum,
        )

    return mesh.run(body)


def assemble(mesh: RankMesh, per_rank: List[GlobalBAResult]) -> GlobalBAResult:
    """The ranks' results as one: the replicated outputs of the first rank
    this process runs, the sharded ones gathered in rank order."""
    first = per_rank[0]
    return GlobalBAResult(
        cam_pose=first.cam_pose,
        pt_pos=mesh.gather([r.pt_pos for r in per_rank]),
        obs_inlier=mesh.gather([r.obs_inlier for r in per_rank]),
        chi2=mesh.gather([r.chi2 for r in per_rank]),
        total_chi2=first.total_chi2,
    )


def optimize_global_sharded(
    sharded: GlobalBAProblem,
    mesh: RankMesh,
    K: Intrinsics,
    iters_first: int = 5,
    iters_second: int = 10,
    cg_iters: int = 60,
) -> GlobalBAResult:
    """`optimize_global_ranks`, assembled: camera outputs replicated, point and
    observation outputs shard-concatenated like the inputs."""
    return assemble(mesh, optimize_global_ranks(sharded, mesh, K, iters_first, iters_second, cg_iters))


def unshard_points(pt_pos: np.ndarray, n_live: int, n_shards: int, owner=None) -> np.ndarray:
    """Shard-concatenated point rows -> live-rank order."""
    P_s = pt_pos.shape[0] // n_shards
    s_of, lp_of, _ = point_layout(n_live, n_shards, owner)
    return pt_pos[s_of * P_s + lp_of]


def write_back(arena, res: GlobalBAResult, cams, pids, fixed, n_shards: int, owner=None) -> None:
    """Free keyframe poses and every problem point into the arena."""
    new_cam, new_pt = host(res.cam_pose), host(res.pt_pos)
    cams_arr = np.asarray(cams, np.int64)
    free = ~host(fixed)[: len(cams_arr)]
    arena.kf_pose[cams_arr[free]] = new_cam[: len(cams_arr)][free]
    arena.pt_pos[np.asarray(pids, np.int64)] = unshard_points(new_pt, len(pids), n_shards, owner)


def run_global_ba_dist(arena, cfg, K: Intrinsics, mesh: RankMesh, iters: Tuple[int, int] = (5, 10)) -> dict:
    """Full-map distributed BA + write-back: build, shard, solve over the mesh."""
    prob, cams, pids = global_ba.build_global_problem(arena, cfg)
    n = mesh.size
    sharded = shard_problem(prob, n, device=mesh.shard_device)
    res = optimize_global_sharded(sharded, mesh, K, iters_first=iters[0], iters_second=iters[1])
    write_back(arena, res, cams, pids, prob.cam_fixed, n)
    return {"cams": len(cams), "points": len(pids), "devices": n, "chi2": float(res.total_chi2)}
