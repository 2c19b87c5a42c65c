"""Map-block sharding: partition the map by covisibility segment over the
ranks of a mesh, run the global BA with segment-owned points, and migrate
point ownership after a loop closure, off the per-frame path.

Port of slam_framework_tpu/parallel/map_shard.py:

  1. Partition unit = covisibility block: keyframes are split into contiguous
     id segments balanced by observation count (covisibility is temporally
     local except at loops), each segment owned by one rank; a point lives
     with the segment holding the MOST of its observations.
  2. Global BA over the partition: `dist_ba.shard_problem(owner=)` deals each
     point with its observations to its segment's rank, so its normal-equation
     block and Schur contribution are rank-local; the only traffic between
     ranks is the sum of the reduced camera system, which is exactly the
     boundary coupling (a segment-interior point adds zeros to every other
     rank's camera rows).
  3. Migration: after a loop closure fuses geometry across segments, owners
     are recomputed and point rows move between ranks in ONE `all_to_all`
     (`migrate_points`), where the global BA's merge already runs.

`partition_arena` is host numpy, equal to the reference's array for array.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from slam_framework_torch.geometry.projection import Intrinsics
from slam_framework_torch.optim import global_ba
from slam_framework_torch.parallel import dist_ba
from slam_framework_torch.parallel.mesh import RankMesh


@dataclasses.dataclass
class MapPartition:
    """Covisibility-segment partition of the arena."""

    n_segments: int
    seg_of_kf: np.ndarray     # (num_kfs,) int32 — segment per keyframe slot (-1 invalid)
    owner_of_pt: np.ndarray   # (num_pts,) int32 — owning segment per point (-1 invalid)
    boundary_pt: np.ndarray   # (num_pts,) bool — observed from >= 2 segments

    def stats(self) -> dict:
        live = self.owner_of_pt >= 0
        per_seg = np.bincount(self.owner_of_pt[live], minlength=self.n_segments)
        return {
            "segments": self.n_segments,
            "points_per_segment": per_seg.tolist(),
            "boundary_points": int(self.boundary_pt.sum()),
            "boundary_frac": float(self.boundary_pt.sum() / max(live.sum(), 1)),
        }


def partition_arena(arena, n_segments: int) -> MapPartition:
    """Split keyframes into contiguous id segments balanced by observation load;
    assign each point to the segment holding most of its observations."""
    kfs = np.nonzero(arena.kf_valid[: arena.num_kfs])[0]
    pids = np.nonzero(arena.pt_valid[: arena.num_pts])[0]
    seg_of_kf = np.full(arena.num_kfs, -1, np.int32)
    owner = np.full(arena.num_pts, -1, np.int32)
    boundary = np.zeros(arena.num_pts, bool)
    if len(kfs) == 0:
        return MapPartition(n_segments, seg_of_kf, owner, boundary)

    # load per keyframe = number of live observations anchored at it
    obs_kf = arena.pt_obs_kf[pids]                     # (Np, O)
    live_obs = obs_kf >= 0
    load = np.bincount(obs_kf[live_obs], minlength=arena.num_kfs)[kfs]
    # contiguous split at balanced cumulative load (keyframe ids are in
    # insertion order, so contiguous id ranges are trajectory segments)
    cum = np.cumsum(load)
    total = cum[-1] if len(cum) else 0
    cuts = np.searchsorted(cum, total * (np.arange(1, n_segments) / n_segments))
    seg_ids = np.zeros(len(kfs), np.int32)
    for c in cuts:
        seg_ids[c:] += 1
    seg_ids = np.minimum(seg_ids, n_segments - 1)
    seg_of_kf[kfs] = seg_ids

    # point owner = argmax over per-segment observation counts
    seg_of_obs = np.where(live_obs, seg_of_kf[np.maximum(obs_kf, 0)], -1)  # (Np, O)
    counts = np.zeros((len(pids), n_segments), np.int32)
    rows = np.broadcast_to(np.arange(len(pids))[:, None], seg_of_obs.shape)
    sel = seg_of_obs >= 0
    np.add.at(counts, (rows[sel], seg_of_obs[sel]), 1)
    owner[pids] = np.argmax(counts, axis=1).astype(np.int32)
    boundary[pids] = (counts > 0).sum(axis=1) >= 2
    return MapPartition(n_segments, seg_of_kf, owner, boundary)


class ShardedMap(NamedTuple):
    """The map's global BA problem dealt to the ranks of a mesh by segment."""

    sharded: global_ba.GlobalBAProblem  # shard-concatenated, on mesh.shard_device
    prob: global_ba.GlobalBAProblem     # the whole problem, host tensors
    cams: np.ndarray                    # keyframe id per camera slot
    pids: np.ndarray                    # point id per live point, in rank order
    owner: np.ndarray                   # rank per live point
    partition: MapPartition


def shard_map_problem(arena, cfg, mesh: RankMesh, partition: Optional[MapPartition] = None) -> ShardedMap:
    """Build the map's global BA problem and deal each point, with its
    observations, to the rank of its covisibility segment (segments map 1:1
    onto ranks when the mesh has as many; otherwise they fold, owner % size)."""
    n = mesh.size
    if partition is None:
        partition = partition_arena(arena, n)
    prob, cams, pids = global_ba.build_global_problem(arena, cfg)
    pids = np.asarray(pids, np.int64)
    owner = partition.owner_of_pt[pids] % n
    sharded = dist_ba.shard_problem(prob, n, owner=owner, device=mesh.shard_device)
    return ShardedMap(sharded, prob, np.asarray(cams), pids, owner, partition)


def run_global_ba_map_sharded(
    arena, cfg, K: Intrinsics, mesh: RankMesh,
    partition: Optional[MapPartition] = None,
    iters: Tuple[int, int] = (5, 10),
) -> dict:
    """Full-map BA with the SEGMENT-OWNED point layout: build, shard by owner,
    solve as one SPMD program over the mesh, write back. The single-device
    optimizer's solution up to the order of the sums."""
    m = shard_map_problem(arena, cfg, mesh, partition)
    res = dist_ba.optimize_global_sharded(m.sharded, mesh, K, iters_first=iters[0], iters_second=iters[1])
    dist_ba.write_back(arena, res, m.cams, m.pids, m.prob.cam_fixed, mesh.size, m.owner)
    out = {"cams": len(m.cams), "points": len(m.pids), "devices": mesh.size, "chi2": float(res.total_chi2)}
    out.update(m.partition.stats())
    return out


# --------------------------------------------------------------------- migration


def migrate_points(
    mesh: RankMesh,
    rows: np.ndarray,        # (D * R, F) f32 — per-rank point rows (R slots each)
    row_mask: np.ndarray,    # (D * R,) bool — live rows
    new_owner: np.ndarray,   # (D * R,) int32 — destination rank per row
) -> Tuple[np.ndarray, np.ndarray]:
    """Re-deal point rows to their new owning ranks with ONE all_to_all.

    Returns (rows', mask') in the same (D * R, F) layout: each rank's block
    holds exactly the rows whose new_owner is that rank, source-rank-major.
    Capacity R must cover the worst destination load: overflow rows are
    dropped with their mask cleared, as are dead rows and rows whose owner is
    no rank. The mask rides as one more float column of the rows, so one
    collective moves both; rows are copied, never computed, so the result is
    bit-equal to the reference's."""
    D = mesh.size
    R = rows.shape[0] // D
    F = rows.shape[1]
    packed = np.concatenate([np.asarray(rows, np.float32), np.asarray(row_mask, np.float32)[:, None]], axis=1)
    packed_t = torch.from_numpy(packed).to(mesh.shard_device)
    owner_t = torch.from_numpy(np.asarray(new_owner, np.int64)).to(mesh.shard_device)

    def body(rank: int) -> torch.Tensor:
        blk = mesh.block(packed_t, rank)                        # (R, F + 1)
        own = mesh.block(owner_t, rank)
        dev = blk.device
        live = (blk[:, F] > 0) & (own >= 0) & (own < D)
        dest = torch.where(live, own, D)                        # dead rows -> bucket D, dropped
        buckets = torch.arange(D + 1, device=dev)
        slot = torch.cumsum((dest[None, :] == buckets[:, None]).to(torch.int64), dim=1) - 1  # (D + 1, R)
        s_idx = slot.gather(0, dest[None, :])[0]                # slot within its bucket
        s_idx = torch.where(live, s_idx, R)                     # dead rows -> slot R, dropped
        send = torch.zeros((D + 1, R + 1, F + 1), dtype=blk.dtype, device=dev)
        send[dest, s_idx] = blk
        got = mesh.all_to_all(send[:D, :R].contiguous())        # (D_src, R, F + 1)
        # compact source-major into this rank's R slots; overflow -> slot R, dropped
        flat = got.reshape(D * R, F + 1)
        m = flat[:, F] > 0
        pos = torch.cumsum(m.to(torch.int64), dim=0) - 1
        idx = torch.where(m & (pos < R), pos, R)
        out = torch.zeros((R + 1, F + 1), dtype=blk.dtype, device=dev)
        out[idx] = flat
        return out[:R]

    full = dist_ba.host(mesh.gather(mesh.run(body)))
    return np.ascontiguousarray(full[:, :F]), full[:, F] > 0
