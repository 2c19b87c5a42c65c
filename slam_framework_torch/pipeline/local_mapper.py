"""Local mapping stage: point culling, multi-view triangulation, neighbour fusion,
keyframe culling and local bundle adjustment around each new keyframe.

Port of slam_framework_tpu/pipeline/local_mapper.py (the LocalMapper thread,
src/core/local_mapper.{h,cpp}: MapPointCulling :232-256, CreateNewMapPoints
:258-492, SearchInNeighbors :494-554, KeyFrameCulling :556-613, and
Optimizer::LocalBundleAdjustment, optimizer.cpp:413-716).

Runs per keyframe on the host thread. Triangulation, fusion and the BA are
device programs (pipeline/mapping_ops.py, optim/local_ba.py) of fixed shape:
each is launched here and its result is written into the arena later, at the
next chunk's host processing or at the next keyframe, fuse strictly before
triangulation before BA, BA results first in first out. The launches return
before the device has finished, so the host goes on while the card works.
The host parts are numpy on the arena, as in the reference.

`process_keyframe` has a critical part (the write-backs and point culling,
which the tracker's block rebuild must see) and a heavy stage (triangulation
and local-BA launches, keyframe culling). Given the tracker's deferral queue
(`defer_queue`, at pipeline depth 2) the heavy stage is queued there and runs
after the tracker has launched its next chunk, as in the reference. One
departure: a heavy stage first lands the triangulation and the BA an earlier
keyframe's stage launched (the "block" write-back policy). The reference lets
a chunk's second keyframe assemble its BA on poses its first keyframe's BA has
not yet refined and lands both BAs at the next fetch, the later one
overwriting the earlier's cameras. Without the landing the bench world's
blackout run on an H100 was lost again after its relocalization, while the
same code on the CPU kept tracking. The two devices compute every stage alike
from the same inputs, up to rounding (tools/replay_blackout.py); the rounding
compounds into maps that differ slightly, and the card's relocalization then
meets the motion-only BA's collapse on a BoW set of about half outliers, which
the reference shares, and tracks on too weak a pose. The landing acts only
where a chunk makes two keyframes (`sync_every` 8 makes that possible);
serially, and in a chunk with one keyframe, nothing changes.

Monocular keyframes get no points but by triangulation, so for them the stage
is synchronous, as in the reference: every pending result is written back when
the keyframe arrives, the heavy stage is never queued, its triangulation and
fusion are applied at once, and the triangulation's minimum baseline is 0.01
(scale-free map units) in place of the stereo baseline.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_framework_torch import resolve_device
from slam_framework_torch.config import SlamConfig
from slam_framework_torch.geometry.projection import Intrinsics
from slam_framework_torch.map.arena import MapArena
from slam_framework_torch.optim import local_ba
from slam_framework_torch.pipeline import kf_store, mapping_ops
from slam_framework_torch.utils.observability import StageTimers


def mapper_device(tracker_device: torch.device, device_index: int) -> torch.device:
    """Where the mapper's programs run: CUDA device `device_index` when there is
    one (so they never contend with the tracker's card), else the last CUDA
    device, which on one card is the tracker's own; the CPU for a CPU tracker."""
    tracker_device = torch.device(tracker_device)
    if tracker_device.type != "cuda":
        return tracker_device
    return torch.device("cuda", min(device_index, torch.cuda.device_count() - 1))


def _to_host(tensors):
    return [t.cpu().numpy() for t in tensors]


class LocalMapper:
    # A BA whose chi2 pass rejects more than this fraction of the window's
    # observations is discarded whole (see flush_ba); 1.0 disables the guard.
    BA_DIVERGENCE_ABORT_FRAC = 0.15

    def __init__(self, cfg: SlamConfig, arena: MapArena, K: Intrinsics, timers=None, device=None):
        """device: the tracker's device (None: the first CUDA device, an error
        when there is none); the mapper's own follows from it and
        `cfg.mapping.device_index` (see `mapper_device`)."""
        self.cfg = cfg
        self.arena = arena
        self.K = K
        self.timers = timers if timers is not None else StageTimers()
        self.device = mapper_device(resolve_device(device), cfg.mapping.device_index)
        self.recent_points: list[tuple[int, int]] = []  # (pid, created_at_kf)
        self.on_erase_keyframe = None  # hook: notify place-recognition database
        # Device-resident keyframe feature store: triangulation/fuse dispatches
        # ship indices + poses + masks; the blocks are gathered from it by index.
        self.kf_store = kf_store.DeviceKFStore(
            cfg.capacity.max_keyframes, arena.kf_xy.shape[1], device=self.device
        )
        self.last_ba_stats: dict = {}
        self.last_triangulation: dict = {}
        self.last_fuse: dict = {}
        # count every time a fixed-capacity window truncates what the reference
        # implementation would have kept
        self.cap_clips: dict = {}
        # Lists: a chunk can promote several keyframes; each appends its
        # local-BA/triangulation/fuse dispatch and all of them land at the next
        # drain. BA pendings apply FIFO, so a same-chunk second keyframe's BA
        # refines on top of the first's write-back.
        self._ba_pendings = []   # [dict] in-flight local BAs awaiting apply
        self._tri_pending = []   # [(kf, nbr_ids, device result)] awaiting apply
        self._fuse_pending = []  # [(nbr_ids, pids_pad, device result)] awaiting apply
        # monocular: the stage runs synchronously (see the module docstring)
        self._sync = cfg.sensor == "monocular"
        self.ba_aborts = 0  # BA results discarded (newer keyframe, or divergence)
        self.n_finalized = 0  # finalize() calls: a caller can tell that its prefetched results are spent
        # running totals over the mapper's life, for run statistics
        self.totals = {"ba_applied": 0, "triangulated": 0, "fused_obs": 0, "merged": 0,
                       "culled_keyframes": 0}

    def _put(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> the mapper's device; uint32 words keep their bits as int32."""
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(self.device)

    def _triangulate(self, idxs, poses, cand, min_baseline):
        blocks = mapping_ops.block_from_store(self.kf_store.packs, self.kf_store.descs, idxs, poses, cand)
        return mapping_ops.compact_first_match(
            mapping_ops.triangulate_with_neighbors(
                mapping_ops.block_at(blocks, 0), mapping_ops.block_at(blocks, slice(1, None)), min_baseline,
                K=self.K, num_levels=self.cfg.orb.num_levels, scale_factor=self.cfg.orb.scale_factor,
            )
        )

    def _fuse(self, idxs, poses, cand, pt_pos, pt_desc, pt_normal, pt_min_d, pt_max_d, pt_mask):
        nbrs = mapping_ops.block_from_store(self.kf_store.packs, self.kf_store.descs, idxs, poses, cand)
        return mapping_ops.fuse_points_into_kfs(
            pt_pos, pt_desc, pt_normal, pt_min_d, pt_max_d, pt_mask, nbrs,
            K=self.K, num_levels=self.cfg.orb.num_levels, scale_factor=self.cfg.orb.scale_factor,
            image_wh=(self.cfg.camera.width, self.cfg.camera.height),
        )

    def note_new_points(self, pids, kf: int) -> None:
        self.recent_points.extend((int(p), kf) for p in np.atleast_1d(pids))

    # ------------------------------------------------------------------ main entry

    def process_keyframe(self, kf: int, prefetched_ba=None, prefetched_tri=None, prefetched_fuse=None,
                         defer_queue=None) -> None:
        """ProcessNewKeyFrame + culling + triangulation + local BA + KF culling
        (the LocalMapper::Run loop, local_mapper.cpp:27-87).

        The local BA, the triangulation and the fusion are launched here and
        their results are written back at the NEXT keyframe (or earlier, by the
        tracker's drain): the reference implementation runs this whole stage on
        a separate thread with the tracker proceeding on bounded-stale map
        state. The tracker reads the results back with its per-chunk drain
        (prefetched_*), so keyframe processing does not wait for the device.
        Callers that need settled state (export) call finalize().

        defer_queue: a list that takes the heavy stage as ("mapper", fn)
        instead of running it here (stereo and RGB-D; monocular runs it here)."""
        # Pending-write-back policy (config.MappingConfig.{ba,trifuse}_writeback).
        # "block" = apply all pendings here, waiting for the device if the drain
        # did not already fetch them; "lag" lets a same-chunk second keyframe's
        # pendings ride to the next drain; "discard" (BA only) drops an unfetched
        # in-flight BA on newer-keyframe arrival (the reference's abort:
        # LocalMapper::InsertKeyFrame -> abort_bundle_adjustment_,
        # local_mapper.cpp:89-93).
        ba_mode = self.cfg.mapping.ba_writeback
        tf_mode = self.cfg.mapping.trifuse_writeback
        with self.timers.time("mapper/writeback"):
            # Each pending is applied EXACTLY once: the fuse dispatch that
            # apply_pending_triangulation appends must never be consumed with
            # this drain's (older) prefetched arrays, hence fuse strictly
            # before tri, and no re-application afterwards. Monocular applies
            # everything here, fetched or not.
            if prefetched_fuse is not None or tf_mode == "block" or self._sync:
                self.apply_pending_fuse(prefetched=prefetched_fuse)
            if self.cfg.mapping.triangulate_new_points and (
                prefetched_tri is not None or tf_mode == "block" or self._sync
            ):
                self.apply_pending_triangulation(prefetched=prefetched_tri)
            if prefetched_ba is not None or ba_mode == "block" or self._sync:
                self.flush_ba(prefetched=prefetched_ba)
            elif self._ba_pendings:
                self.ba_aborts += len(self._ba_pendings)
                self._ba_pendings = []
        # Point culling stays on the critical path: the tracker's local-block
        # rebuild (right after this call) must not re-admit points this
        # keyframe's evidence just condemned. It is cheap vectorized numpy.
        with self.timers.time("mapper/cull_points"):
            self._cull_points(kf)
        if defer_queue is not None and not self._sync:
            defer_queue.append(("mapper", lambda: self._heavy_stage(kf)))
        else:
            self._heavy_stage(kf)

    def _heavy_stage(self, kf: int) -> None:
        """Triangulation/fusion dispatch + local-BA dispatch + keyframe culling
        (problem assembly is numpy over the full window): the part of a
        keyframe's processing that need not precede the tracker's block rebuild.

        Under the "block" write-back policies it first lands the triangulation
        and the BA an earlier keyframe's heavy stage launched: at depth 2 a
        chunk's second keyframe passes its critical part before the first one's
        stage has run, so this is where its BA would otherwise start from poses
        the first BA has not refined (the reference lands both at the next
        fetch). At depth 1, for a chunk's first keyframe and for monocular no
        triangulation or BA is in flight here (the fusion its critical part
        launched stays in flight, as at depth 1)."""
        mapping = self.cfg.mapping
        with self.timers.time("mapper/land_earlier"):
            if mapping.triangulate_new_points and mapping.trifuse_writeback == "block":
                self.apply_pending_triangulation()
            if mapping.ba_writeback == "block":
                self.flush_ba()
        if self.cfg.mapping.triangulate_new_points:
            with self.timers.time("mapper/triangulate"):
                pending = self._dispatch_triangulation(kf)
                if pending is not None and self._sync:
                    self._apply_triangulation(kf, *pending)
                elif pending is not None:
                    self._tri_pending.append((kf,) + pending)
        with self.timers.time("mapper/ba_dispatch"):
            self._local_ba(kf)
        if self.cfg.mapping.cull_keyframes:
            with self.timers.time("mapper/cull_keyframes"):
                self._cull_keyframes(kf)

    def finalize(self) -> None:
        """Drain all in-flight device work into the arena (pending fuse +
        triangulation + local BA). Must run before consumers that need settled
        map state."""
        self.n_finalized += 1
        self.apply_pending_fuse()
        self.apply_pending_triangulation()
        self.flush_ba()

    # ------------------------------------------------------------------ triangulation

    def _dispatch_triangulation(self, kf: int):
        """First half of CreateNewMapPoints (local_mapper.cpp:258-492): build +
        async-dispatch the batched triangulation program for this keyframe
        against its best covisible neighbors. Returns (nbr_ids, device result)."""
        arena = self.arena
        cfg = self.cfg
        Nn = cfg.mapping.triangulation_neighbors
        nbr_ids = arena.covisible_keyframes(
            kf, min_shared=cfg.mapping.covisibility_edge_min, max_n=Nn
        )
        if len(nbr_ids) == 0:
            return None
        # pad to the static neighbor count with disabled slots
        padded = np.concatenate([nbr_ids, np.full(Nn - len(nbr_ids), nbr_ids[0])])
        cand_on = np.arange(Nn) < len(nbr_ids)
        idxs = np.concatenate([[kf], padded]).astype(np.int32)
        self.kf_store.ensure(idxs, arena)
        # free features only (triangulation creates new geometry)
        cand = arena.kf_feat_valid[idxs] & (arena.kf_point_idx[idxs] < 0)
        cand[1:] &= cand_on[:, None]
        min_baseline = 0.01 if self._sync else float(cfg.camera.baseline)
        res = self._triangulate(self._put(idxs), self._put(arena.kf_pose[idxs]), self._put(cand), min_baseline)
        return nbr_ids, res

    def tri_handles(self):
        """Device tensors of the in-flight triangulation result(s), or None: the
        tracker reads these back with its per-chunk drain (see ba_handles).
        4 tensors per pending entry, in pending order."""
        if not self._tri_pending:
            return None
        out = []
        for (_, _, res) in self._tri_pending:
            out += [res.ni, res.nf, res.pts, res.valid]
        return out

    def apply_pending_triangulation(self, prefetched=None) -> None:
        """Insert the pending (async) triangulation result(s) into the map.
        With prefetched host arrays (4 per entry, tri_handles order) this does
        not touch the device."""
        pending, self._tri_pending = self._tri_pending, []
        for i, (kf, nbr_ids, res) in enumerate(pending):
            if not self.arena.kf_valid[kf]:
                continue  # keyframe culled while the triangulation was in flight
            # defensive: a pending entry beyond the drain-time snapshot has no
            # prefetched rows — fall back to a blocking fetch, never slice short
            pf = prefetched[4 * i: 4 * i + 4] if prefetched is not None else None
            if pf is not None and len(pf) < 4:
                pf = None
            self._apply_triangulation(kf, nbr_ids, res, prefetched=pf)

    def _apply_triangulation(self, kf: int, nbr_ids, res, prefetched=None) -> None:
        """Second half of CreateNewMapPoints: fetch the (compacted) device result
        and insert the new points (vectorized; the reference's per-match loop is
        local_mapper.cpp:416-491)."""
        arena = self.arena
        cfg = self.cfg
        if prefetched is not None:
            ni_all, nf_all, pts, valid = prefetched
        else:
            ni_all, nf_all, pts, valid = _to_host([res.ni, res.nf, res.pts, res.valid])

        F = valid.shape[0]
        f_all = np.nonzero(valid)[0]
        # feature not already bound on this KF
        f_all = f_all[arena.kf_point_idx[kf, f_all] < 0]
        ni = ni_all[f_all]
        nbr_arr = np.asarray(nbr_ids, np.int64)[ni]
        nf = nf_all[f_all]
        # neighbor feature must be free (and the neighbor not culled while the
        # result was in flight), and claimed at most once this pass
        free = (arena.kf_point_idx[nbr_arr, nf] < 0) & arena.kf_valid[nbr_arr]
        f_all, ni, nbr_arr, nf = f_all[free], ni[free], nbr_arr[free], nf[free]
        pair_key = nbr_arr * (np.int64(F) + 1) + nf
        _, first_idx = np.unique(pair_key, return_index=True)
        keep = np.sort(first_idx)
        f_all, ni, nbr_arr, nf = f_all[keep], ni[keep], nbr_arr[keep], nf[keep]

        n_new = 0
        if len(f_all):
            pos = pts[f_all]
            center = -arena.kf_pose[kf, :3, :3].T @ arena.kf_pose[kf, :3, 3]
            delta = pos - center
            dist = np.linalg.norm(delta, axis=1)
            ok = dist > 1e-6
            f_all, nbr_arr, nf, pos, delta, dist = (
                f_all[ok], nbr_arr[ok], nf[ok], pos[ok], delta[ok], dist[ok]
            )
            sf = cfg.orb.scale_factor
            max_dist = dist * sf ** arena.kf_octave[kf, f_all].astype(np.float32)
            pids = arena.add_points(
                pos, arena.kf_desc[kf, f_all], kf, delta / dist[:, None],
                max_dist / (sf ** (cfg.orb.num_levels - 1)), max_dist,
            )
            arena.associate_batch(kf, f_all, pids)
            # nbr_arr rows are unique pairs but a pid appears once — safe
            arena.associate_batch(nbr_arr, nf, pids)
            self.recent_points.extend((int(p), kf) for p in pids)
            n_new = len(pids)
        self.last_triangulation = {"neighbors": len(nbr_ids), "new_points": n_new}
        self.totals["triangulated"] += n_new
        # SearchInNeighbors (local_mapper.cpp:494-554) now that this keyframe's
        # points (old + freshly triangulated) are settled: fuse them into the
        # covisible keyframes — adds confirming observations (raising obs counts
        # toward the >=3 the keyframe policy and culling reason about) and merges
        # duplicate landmarks. In flight like BA/triangulation (fetched by the
        # tracker's drain, applied at the next keyframe); applied at once for
        # monocular, whose young map needs fresh observation counts.
        with self.timers.time("mapper/fuse_neighbors"):
            pending = self._dispatch_fuse(kf)
            if pending is not None and self._sync:
                self._apply_fuse(*pending)
            elif pending is not None:
                self._fuse_pending.append(pending)

    # ------------------------------------------------------------------ neighbor fusion
    # LocalMapper::SearchInNeighbors + OrbMatcher::Fuse (local_mapper.cpp:494-554,
    # orb_matcher.cpp:804-954): fuse a keyframe's map points into its covisible
    # neighbors. The reverse direction (neighbors' points into the keyframe) is
    # covered at creation by track_ops.fuse_candidates against the local block.

    def _search_in_neighbors(self, kf: int) -> None:
        """Synchronous dispatch + apply (tests / direct callers)."""
        pending = self._dispatch_fuse(kf)
        if pending is not None:
            self._apply_fuse(*pending)

    def _dispatch_fuse(self, kf: int):
        """Build + launch the batched fuse program over all covisible neighbors.
        Returns (nbr_ids, pids_pad, device result) or None."""
        arena = self.arena
        cfg = self.cfg
        if not arena.kf_valid[kf]:
            return None
        Nn = cfg.mapping.triangulation_neighbors
        nbr_ids = arena.covisible_keyframes(
            kf, min_shared=cfg.mapping.covisibility_edge_min, max_n=Nn
        )
        if len(nbr_ids) == 0:
            return None
        pids_row = arena.kf_point_idx[kf]
        pids = np.unique(pids_row[pids_row >= 0])
        pids = pids[arena.pt_valid[pids]]
        if len(pids) == 0:
            return None
        P = arena.kf_point_idx.shape[1]
        pids_pad = np.zeros(P, np.int64)
        pmask = np.zeros(P, bool)
        pids_pad[: len(pids)] = pids
        pmask[: len(pids)] = True
        padded = np.concatenate([nbr_ids, np.full(Nn - len(nbr_ids), nbr_ids[0])])
        cand_on = np.arange(Nn) < len(nbr_ids)
        idxs = padded.astype(np.int32)
        self.kf_store.ensure(idxs, arena)
        # ALL valid features (bound features become merge candidates)
        cand = arena.kf_feat_valid[idxs] & cand_on[:, None]
        put = self._put
        res = self._fuse(
            put(idxs), put(arena.kf_pose[idxs]), put(cand),
            put(arena.pt_pos[pids_pad]),
            put(arena.pt_desc[pids_pad]),
            put(arena.pt_normal[pids_pad]),
            put(arena.pt_min_dist[pids_pad]),
            put(arena.pt_max_dist[pids_pad]),
            put(pmask),
        )
        return nbr_ids, pids_pad, res

    def fuse_handles(self):
        """Device tensors of the in-flight fuse result(s), or None: the tracker
        reads these back with its per-chunk drain (one tensor per entry)."""
        if not self._fuse_pending:
            return None
        return [res for (_, _, res) in self._fuse_pending]

    def apply_pending_fuse(self, prefetched=None) -> None:
        pending, self._fuse_pending = self._fuse_pending, []
        for i, (nbr_ids, pids_pad, res) in enumerate(pending):
            pf = prefetched[i: i + 1] if prefetched is not None else None
            if pf is not None and len(pf) == 0:
                pf = None  # entry newer than the drain-time snapshot
            self._apply_fuse(nbr_ids, pids_pad, res, prefetched=pf)

    def _apply_fuse(self, nbr_ids, pids_pad, res, prefetched=None) -> None:
        """Host write-back: add-observation on a free neighbor feature, or merge on
        a bound one (duplicate landmark — MapPoint::Replace, map_point.cpp:190-226,
        the more-observed point wins). Validity re-checked per row: points/keyframes
        may have been culled while the result was in flight."""
        arena = self.arena
        if prefetched is not None:
            assoc = np.asarray(prefetched[0])
        else:
            assoc = res.cpu().numpy()  # (Nn, F) into pids_pad, -1 none
        n_added = n_merged = 0
        for n, nbr in enumerate(np.asarray(nbr_ids)):
            nbr = int(nbr)
            if not arena.kf_valid[nbr]:
                continue
            feats = np.nonzero(assoc[n] >= 0)[0]
            if len(feats) == 0:
                continue
            cand = pids_pad[assoc[n, feats]]
            alive = arena.pt_valid[cand]
            feats, cand = feats[alive], cand[alive]
            existing = arena.kf_point_idx[nbr, feats]
            differs = existing != cand
            feats, cand, existing = feats[differs], cand[differs], existing[differs]
            bound = (existing >= 0) & arena.pt_valid[np.maximum(existing, 0)]

            # free features: one vectorized associate_batch. "Already observed in
            # this keyframe" = pid present in the keyframe's binding row (bindings
            # and observations are kept in lockstep by the arena).
            f_free, p_free = feats[~bound], cand[~bound]
            if len(p_free):
                row = arena.kf_point_idx[nbr]
                seen = np.zeros(arena.num_pts, bool)
                seen[row[row >= 0]] = True
                keep = ~seen[p_free]
                f_free, p_free = f_free[keep], p_free[keep]
                _, first = np.unique(p_free, return_index=True)  # pid once per call
                first = np.sort(first)
                f_free, p_free = f_free[first], p_free[first]
                if len(p_free):
                    arena.associate_batch(nbr, f_free, p_free.astype(np.int64))
                    n_added += len(p_free)

            # bound features: duplicate landmarks — merge (rare; loop is fine)
            for f, pid, ex in zip(feats[bound], cand[bound], existing[bound]):
                pid, ex = int(pid), int(ex)
                if not arena.pt_valid[pid] or not arena.pt_valid[ex] or pid == ex:
                    continue  # merged away earlier in this pass
                if arena.pt_obs_count[ex] >= arena.pt_obs_count[pid]:
                    arena.merge_points(ex, pid)
                else:
                    arena.merge_points(pid, ex)
                n_merged += 1
        self.last_fuse = {
            "neighbors": len(nbr_ids), "added_obs": n_added, "merged": n_merged,
        }
        self.totals["fused_obs"] += n_added
        self.totals["merged"] += n_merged

    # ------------------------------------------------------------------ KF culling

    def _cull_keyframes(self, kf: int) -> None:
        """KeyFrameCulling (local_mapper.cpp:556-613): a covisible keyframe is
        redundant when >= 90% of its (>=3-obs) points are seen by >= 3 other
        keyframes at the same or finer scale."""
        arena = self.arena
        cfg = self.cfg
        for k in arena.covisible_keyframes(kf, min_shared=cfg.mapping.covisibility_edge_min):
            k = int(k)
            if k == 0 or k == kf or not arena.kf_valid[k]:
                continue
            # recency guard: our fuse-at-creation gives young points >=3 obs
            # immediately, so the reference's redundancy test would erase brand-new
            # keyframes and collapse the local-BA window. Only cull once settled.
            if kf - k < cfg.mapping.kf_cull_min_age:
                continue
            feats = np.nonzero(arena.kf_point_idx[k] >= 0)[0]
            if len(feats) == 0:
                continue
            pids = arena.kf_point_idx[k, feats]
            alive = arena.pt_valid[pids]
            feats, pids = feats[alive], pids[alive]
            if len(feats) == 0:
                continue
            consider = arena.pt_obs_count[pids] >= 3
            if consider.sum() == 0:
                continue
            own_oct = arena.kf_octave[k, feats].astype(np.int32)
            obs_kf = arena.pt_obs_kf[pids]          # (n, O)
            obs_ft = arena.pt_obs_feat[pids]
            other = (obs_kf >= 0) & (obs_kf != k)
            oct_other = arena.kf_octave[
                np.maximum(obs_kf, 0), np.maximum(obs_ft, 0)
            ].astype(np.int32)
            good = other & (oct_other <= own_oct[:, None] + 1)
            redundant = consider & (good.sum(axis=1) >= 3)
            if redundant.sum() > cfg.mapping.kf_cull_redundancy * consider.sum():
                arena.erase_keyframe(k)
                self.totals["culled_keyframes"] += 1
                if self.on_erase_keyframe:
                    self.on_erase_keyframe(k)

    # ------------------------------------------------------------------ culling

    def _cull_points(self, current_kf: int) -> None:
        """MapPointCulling (local_mapper.cpp:232-256): drop recent points with a bad
        found/visible ratio or too few observations after 2 keyframes."""
        arena = self.arena
        if not self.recent_points:
            return
        arr = np.asarray(self.recent_points, np.int64).reshape(-1, 2)
        pid, born = arr[:, 0], arr[:, 1]
        alive = arena.pt_valid[pid]
        pid, born = pid[alive], born[alive]
        age = current_kf - born
        ratio = arena.pt_n_found[pid] / np.maximum(arena.pt_n_visible[pid], 1)
        kill = (ratio < self.cfg.mapping.point_cull_found_ratio) & (age >= 1)
        # reference uses obs<=3 here (local_mapper.cpp:246-251) with per-frame
        # observation accrual; our keyframes sync with a lag, so observations
        # accrue slower — require only that SOME second view confirmed the point.
        kill |= (age >= 2) & (arena.pt_obs_count[pid] <= 1)
        arena.erase_points_batch(np.unique(pid[kill]))
        keep = ~kill & (age < 3)  # age>=3 survivors leave probation
        self.recent_points = list(zip(pid[keep].tolist(), born[keep].tolist()))

    # ------------------------------------------------------------------ local BA

    def _local_ba(self, kf: int) -> None:
        cfg = self.cfg
        arena = self.arena
        cap = cfg.capacity

        # Camera window: this KF + covisible, then fixed boundary cams (optimizer.cpp:416-460)
        window = [kf] + list(
            arena.covisible_keyframes(kf, min_shared=cfg.mapping.covisibility_edge_min)
        )
        full_window = len(window)
        window = window[: max(cap.ba_cams - 8, 1)]
        if full_window > len(window):
            self.cap_clips["ba_window_cams"] = (
                self.cap_clips.get("ba_window_cams", 0) + full_window - len(window)
            )
        window_set = set(int(k) for k in window)

        # Points observed by window cams
        pid_set = arena.kf_point_idx[np.asarray(window, np.int64)].reshape(-1)
        pid_set = np.unique(pid_set[pid_set >= 0])
        pid_set = pid_set[arena.pt_valid[pid_set]]
        if len(pid_set) > cap.ba_points:
            # keep the most-observed points
            self.cap_clips["ba_points"] = (
                self.cap_clips.get("ba_points", 0) + len(pid_set) - cap.ba_points
            )
            order = np.argsort(-arena.pt_obs_count[pid_set], kind="stable")
            pid_set = pid_set[order[: cap.ba_points]]
        if len(pid_set) == 0 or len(window) < 2:
            return

        # Boundary: cams observing these points but outside the window -> fixed
        obs_kf = arena.pt_obs_kf[pid_set]  # (n, O)
        flat = np.unique(obs_kf[obs_kf >= 0])
        boundary = [int(k) for k in flat if int(k) not in window_set and arena.kf_valid[k]]
        boundary = boundary[: cap.ba_cams - len(window)]
        cams = window + boundary

        C, P, M, O = cap.ba_cams, cap.ba_points, cap.ba_obs, cap.ba_obs_per_point
        cam_pose = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
        cam_pose[: len(cams)] = arena.kf_pose[np.asarray(cams, np.int64)]
        cam_fixed = np.ones(C, bool)
        cam_fixed[: len(window)] = False
        # always fix the oldest cam in the problem to anchor the gauge (reference fixes
        # kf id 0 / boundary cams; with no boundary the window's oldest is pinned)
        if not boundary:
            cam_fixed[int(np.argmin([arena.kf_frame_id[c] for c in cams]))] = True
        cam_mask = np.zeros(C, bool)
        cam_mask[: len(cams)] = True

        pt_pos = np.zeros((P, 3), np.float32)
        pt_pos[: len(pid_set)] = arena.pt_pos[pid_set]
        pt_mask = np.zeros(P, bool)
        pt_mask[: len(pid_set)] = True

        # Observations from the per-point obs table (fully vectorized: the python
        # loop version cost ~200 ms per keyframe at KITTI scale)
        inv_sf2 = 1.0 / (cfg.orb.scale_factor ** (2.0 * np.arange(cfg.orb.num_levels)))
        kf_to_cam = np.full(arena.num_kfs, -1, np.int32)
        for i, c in enumerate(cams):
            kf_to_cam[c] = i
        obs_kf_tab = arena.pt_obs_kf[pid_set][:, :O]     # (P', O) capped fan-in
        obs_ft_tab = arena.pt_obs_feat[pid_set][:, :O]
        valid_tab = obs_kf_tab >= 0
        cam_tab = np.where(valid_tab, kf_to_cam[np.maximum(obs_kf_tab, 0)], -1)
        valid_tab &= cam_tab >= 0
        # flat order: point-major; rank within point = slot index
        flat_valid = valid_tab.reshape(-1)
        sel = np.nonzero(flat_valid)[0][:M]
        m = len(sel)
        pi_flat = (sel // O).astype(np.int32)
        kf_flat = obs_kf_tab.reshape(-1)[sel]
        ft_flat = obs_ft_tab.reshape(-1)[sel]
        obs_cam = np.zeros(M, np.int32)
        obs_pt = np.zeros(M, np.int32)
        obs_uv = np.zeros((M, 2), np.float32)
        obs_ur = np.full(M, -1.0, np.float32)
        obs_w = np.ones(M, np.float32)
        obs_mask = np.zeros(M, bool)
        obs_cam[:m] = cam_tab.reshape(-1)[sel]
        obs_pt[:m] = pi_flat
        obs_uv[:m] = arena.kf_xy[kf_flat, ft_flat]
        obs_ur[:m] = arena.kf_ur[kf_flat, ft_flat]
        obs_w[:m] = inv_sf2[
            np.clip(arena.kf_octave[kf_flat, ft_flat], 0, cfg.orb.num_levels - 1)
        ]
        obs_mask[:m] = True
        # per-point slot lists: rank of each obs within its point
        rank = (np.cumsum(valid_tab, axis=1) - 1).reshape(-1)[sel]
        pt_slots = np.full((P, O), -1, np.int32)
        pt_slots[pi_flat, rank] = np.arange(m, dtype=np.int32)

        put = self._put
        prob = local_ba.BAProblem(
            cam_pose=put(cam_pose),
            cam_fixed=put(cam_fixed),
            cam_mask=put(cam_mask),
            pt_pos=put(pt_pos),
            pt_mask=put(pt_mask),
            obs_cam=put(obs_cam),
            obs_pt=put(obs_pt),
            obs_uv=put(obs_uv),
            obs_ur=put(obs_ur),
            obs_inv_sigma2=put(obs_w),
            obs_mask=put(obs_mask),
            pt_obs_slots=put(pt_slots),
        )
        # launched without waiting for the device: results land at flush_ba()
        res = local_ba.optimize(
            prob, self.K, iters_first=cfg.mapping.local_ba_iters_first,
            iters_second=cfg.mapping.local_ba_iters_second,
        )
        self._ba_pendings.append({
            "res": res, "cams": cams, "cam_fixed": cam_fixed, "pid_set": pid_set,
            "obs_mask": obs_mask, "m": m, "pi_flat": pi_flat,
            "kf_flat": kf_flat, "ft_flat": ft_flat,
        })

    def ba_handles(self):
        """Device tensors of the in-flight BA results (4 per pending, FIFO), or
        None: callers read them back together with their own results, then
        pass the host arrays to flush_ba(prefetched=...)."""
        if not self._ba_pendings:
            return None
        out = []
        for p in self._ba_pendings:
            res = p["res"]
            out += [res.cam_pose, res.pt_pos, res.obs_inlier, res.total_chi2]
        return out

    def flush_ba(self, prefetched=None) -> None:
        """Fetch + write back ALL in-flight local BAs (FIFO). Must run before
        any consumer that needs settled poses/points (loop closer, export).
        prefetched, when given, is the flat drain payload: 4 arrays per
        pending, in ba_handles() order; pendings dispatched AFTER that snapshot
        fall back to a direct fetch."""
        pendings, self._ba_pendings = self._ba_pendings, []
        for i, pending in enumerate(pendings):
            grp = None
            if prefetched is not None and 4 * (i + 1) <= len(prefetched):
                grp = prefetched[4 * i : 4 * i + 4]
            self._apply_ba(pending, grp)

    def _apply_ba(self, pending, prefetched=None) -> None:
        arena = self.arena
        res = pending["res"]
        cams, cam_fixed = pending["cams"], pending["cam_fixed"]
        pid_set, m = pending["pid_set"], pending["m"]
        if prefetched is not None:
            new_cam, new_pt, inlier, total_chi2 = prefetched
        else:
            new_cam, new_pt, inlier, total_chi2 = _to_host(
                [res.cam_pose, res.pt_pos, res.obs_inlier, res.total_chi2]
            )
        m = pending["m"]
        # Divergence guard: a BA whose chi2 classification rejects > 15% of
        # the window's observations is not reporting outliers — it is
        # reporting its own inconsistency (seen post-relocalization, where
        # new keyframes couple to pre-blackout boundary cams: one such BA
        # erased 527 of 2139 obs and starved tracking into a second loss;
        # keeping the obs but applying the poses instead let the next BA drag
        # the keyframes — equally fatal). Discard the whole result, like the
        # reference aborts an interrupted BA (local_mapper.cpp:89-93).
        n_bad = int((pending["obs_mask"][:m] & ~inlier[:m]).sum())
        if m > 0 and n_bad > self.BA_DIVERGENCE_ABORT_FRAC * m:
            self.last_ba_stats = {
                "cams": len(pending["cams"]),
                "fixed": int(pending["cam_fixed"][: len(pending["cams"])].sum()),
                "points": len(pending["pid_set"]), "obs": m, "outliers": 0,
                "aborted_divergent": n_bad, "chi2": float(total_chi2),
            }
            self.ba_aborts += 1
            return
        self.totals["ba_applied"] += 1
        # Write back free cameras and surviving points
        for i, c in enumerate(cams):
            if not cam_fixed[i] and arena.kf_valid[c]:
                arena.kf_pose[c] = new_cam[i]
        alive = arena.pt_valid[pid_set]
        arena.pt_pos[pid_set[alive]] = new_pt[: len(pid_set)][alive]

        # Erase outlier observations (optimizer.cpp:670-704), vectorized: unbind
        # the feature rows, batch-remove the observations, then erase points
        # starved below 2 observations. (Mass rejection was already caught by
        # the divergence guard above.)
        bad = np.nonzero(pending["obs_mask"][:m] & ~inlier[:m])[0]
        pi_flat, kf_flat, ft_flat = pending["pi_flat"], pending["kf_flat"], pending["ft_flat"]
        n_erased = 0
        if len(bad):
            pid_bad = pid_set[pi_flat[bad]].astype(np.int64)
            kf_bad = kf_flat[bad].astype(np.int64)
            ft_bad = ft_flat[bad].astype(np.int64)
            live = arena.pt_valid[pid_bad]
            pid_bad, kf_bad, ft_bad = pid_bad[live], kf_bad[live], ft_bad[live]
            bound = arena.kf_point_idx[kf_bad, ft_bad] == pid_bad
            arena.kf_point_idx[kf_bad[bound], ft_bad[bound]] = -1
            arena.remove_observations_batch(pid_bad, kf_bad)
            n_erased = len(pid_bad)
            starved = np.unique(pid_bad[arena.pt_obs_count[pid_bad] <= 1])
            arena.erase_points_batch(starved)
        self.last_ba_stats = {
            "cams": len(cams),
            "fixed": int(cam_fixed[: len(cams)].sum()),
            "points": len(pid_set),
            "obs": m,
            "outliers": n_erased,
            "chi2": float(total_chi2),
        }
