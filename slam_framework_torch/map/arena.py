"""Fixed-capacity array map: keyframes, map points, observations — no pointer graph.

Copy of slam_framework_tpu/map/arena.py (host numpy), with its imports
redirected to this package.

TPU-native replacement for the reference's Map/KeyFrame/MapPoint pointer web
(reference: src/data/map.{h,cpp}, keyframe.{h,cpp}, map_point.{h,cpp}). Design per
SURVEY.md §7: the map is preallocated arrays + liveness masks; "culling" is a mask
write; the covisibility graph is derived from the observation tables on demand; there
are no per-object mutexes because sequencing is explicit (pipeline stages).

The arena lives on host (numpy): map mutation is scalar bookkeeping, while all heavy
math happens on device against fixed-shape *views* assembled from these arrays
(local-map blocks, BA problems). Capacities come from CapacityConfig.

Observation bookkeeping (two-way, both fixed width):
  - kf_point_idx[kf, feat]  -> point id or -1   (the KeyFrame feature->MapPoint map)
  - obs_kf/obs_feat[point, slot] -> observing (kf, feat), obs_count per point
    (MapPoint::observations_, map_point.cpp:114-153, capped at max_obs_per_point)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from slam_framework_torch import native
from slam_framework_torch.config import CapacityConfig


@dataclasses.dataclass
class MapArena:
    cap: CapacityConfig

    # --- keyframes ---
    kf_pose: np.ndarray          # (K, 4, 4) Tcw
    kf_valid: np.ndarray         # (K,) bool
    kf_frame_id: np.ndarray      # (K,) int64 source frame id
    kf_timestamp: np.ndarray     # (K,) float64
    kf_xy: np.ndarray            # (K, N, 2) f32 feature pixels (undistorted, level 0)
    kf_ur: np.ndarray            # (K, N) f32 right-u (-1 mono)
    kf_depth: np.ndarray         # (K, N) f32 stereo/RGBD depth (-1 none)
    kf_octave: np.ndarray        # (K, N) int16
    kf_angle: np.ndarray         # (K, N) f32
    kf_desc: np.ndarray          # (K, N, 8) uint32
    kf_feat_valid: np.ndarray    # (K, N) bool
    kf_point_idx: np.ndarray     # (K, N) int32 -> point id or -1

    # --- map points ---
    pt_pos: np.ndarray           # (P, 3) f32 world position
    pt_valid: np.ndarray         # (P,) bool
    pt_normal: np.ndarray        # (P, 3) f32 mean viewing direction
    pt_min_dist: np.ndarray      # (P,) f32 scale-invariance range
    pt_max_dist: np.ndarray     # (P,) f32
    pt_desc: np.ndarray          # (P, 8) uint32 distinctive descriptor
    pt_n_visible: np.ndarray     # (P,) int32  (MapPoint::IncreaseVisible)
    pt_n_found: np.ndarray       # (P,) int32  (MapPoint::IncreaseFound)
    pt_first_kf: np.ndarray      # (P,) int32 creating keyframe
    pt_obs_kf: np.ndarray        # (P, O) int32 observing KF or -1
    pt_obs_feat: np.ndarray      # (P, O) int32 feature index in that KF
    pt_obs_count: np.ndarray     # (P,) int32

    # --- spanning-tree surgery on deletion (keyframe.cpp:546-607) ---
    # At cull time a keyframe is assigned its best covisible live keyframe as
    # parent and the RELATIVE transform to it is frozen (Tcp_ = Tcw * parent.Twc,
    # keyframe.cpp:602-607). Trajectory export composes through parent chains so
    # frames whose reference keyframe was culled still follow BA / loop-closure
    # refinements of the surviving ancestors (slam_system.cpp:264-314).
    kf_parent: Optional[np.ndarray] = None        # (K,) int32, -1 = none/live root
    kf_rel_to_parent: Optional[np.ndarray] = None  # (K, 4, 4) f32 Tcp at cull time

    num_kfs: int = 0             # high-water marks (ids are never reused)
    num_pts: int = 0
    next_point_id: int = 0

    @staticmethod
    def create(cap: CapacityConfig, max_features: Optional[int] = None) -> "MapArena":
        K, P, N, O = cap.max_keyframes, cap.max_map_points, max_features or cap.max_features, cap.max_obs_per_point
        return MapArena(
            cap=cap,
            kf_pose=np.tile(np.eye(4, dtype=np.float32), (K, 1, 1)),
            kf_valid=np.zeros(K, bool),
            kf_frame_id=np.zeros(K, np.int64),
            kf_timestamp=np.zeros(K, np.float64),
            kf_xy=np.zeros((K, N, 2), np.float32),
            kf_ur=np.full((K, N), -1.0, np.float32),
            kf_depth=np.full((K, N), -1.0, np.float32),
            kf_octave=np.zeros((K, N), np.int16),
            kf_angle=np.zeros((K, N), np.float32),
            kf_desc=np.zeros((K, N, 8), np.uint32),
            kf_feat_valid=np.zeros((K, N), bool),
            kf_point_idx=np.full((K, N), -1, np.int32),
            pt_pos=np.zeros((P, 3), np.float32),
            pt_valid=np.zeros(P, bool),
            pt_normal=np.zeros((P, 3), np.float32),
            pt_min_dist=np.zeros(P, np.float32),
            pt_max_dist=np.zeros(P, np.float32),
            pt_desc=np.zeros((P, 8), np.uint32),
            pt_n_visible=np.zeros(P, np.int32),
            pt_n_found=np.zeros(P, np.int32),
            pt_first_kf=np.zeros(P, np.int32),
            pt_obs_kf=np.full((P, O), -1, np.int32),
            pt_obs_feat=np.full((P, O), -1, np.int32),
            pt_obs_count=np.zeros(P, np.int32),
            kf_parent=np.full(K, -1, np.int32),
            kf_rel_to_parent=np.tile(np.eye(4, dtype=np.float32), (K, 1, 1)),
        )

    # ------------------------------------------------------------------ keyframes

    def add_keyframe(
        self,
        pose: np.ndarray,
        frame_id: int,
        timestamp: float,
        xy: np.ndarray,
        ur: np.ndarray,
        depth: np.ndarray,
        octave: np.ndarray,
        angle: np.ndarray,
        desc: np.ndarray,
        feat_valid: np.ndarray,
        point_idx: np.ndarray,
    ) -> int:
        """Insert a keyframe; returns its id. Registers observations for all features
        already associated to map points (point_idx)."""
        k = self.num_kfs
        if k >= self.cap.max_keyframes:
            raise RuntimeError("keyframe arena full — raise CapacityConfig.max_keyframes")
        self.kf_pose[k] = pose
        self.kf_valid[k] = True
        self.kf_frame_id[k] = frame_id
        self.kf_timestamp[k] = timestamp
        n = xy.shape[0]
        self.kf_xy[k, :n] = xy
        self.kf_ur[k, :n] = ur
        self.kf_depth[k, :n] = depth
        self.kf_octave[k, :n] = octave
        self.kf_angle[k, :n] = angle
        self.kf_desc[k, :n] = desc
        self.kf_feat_valid[k, :n] = feat_valid
        self.kf_point_idx[k, :n] = point_idx
        self.num_kfs = k + 1
        # register observations (native hot loop; see native/arena_ops.cpp)
        lib = native.load_arena_ops()
        if lib is not None:
            row = self.kf_point_idx[k]
            lib.register_observations(
                k, native.as_i32p(row), row.shape[0],
                native.as_i32p(self.pt_obs_kf), native.as_i32p(self.pt_obs_feat),
                native.as_i32p(self.pt_obs_count), self.cap.max_obs_per_point,
            )
        else:
            for f in np.nonzero(point_idx >= 0)[0]:
                self._add_observation(int(point_idx[f]), k, int(f))
        return k

    def erase_keyframe(self, kf: int) -> None:
        """SetBadFlag equivalent (keyframe.cpp:515-614): assign a spanning-tree
        parent (best covisible live keyframe) with a frozen relative transform
        (keyframe.cpp:546-607), then remove all observations and mark invalid."""
        # Spanning-tree surgery BEFORE dropping observations: the parent is the
        # most-covisible live keyframe; fall back to the nearest older live one.
        counts = self.covisibility_counts(kf)
        parent = int(np.argmax(counts)) if counts.size and counts.max() > 0 else -1
        if parent < 0:
            older = np.nonzero(self.kf_valid[:kf])[0]
            parent = int(older[-1]) if len(older) else -1
        if parent >= 0 and self.kf_parent is not None:
            self.kf_parent[kf] = parent
            Tpw = self.kf_pose[parent].astype(np.float64)
            Rp, tp = Tpw[:3, :3], Tpw[:3, 3]
            Twp = np.eye(4)
            Twp[:3, :3] = Rp.T
            Twp[:3, 3] = -Rp.T @ tp
            self.kf_rel_to_parent[kf] = (
                self.kf_pose[kf].astype(np.float64) @ Twp
            ).astype(np.float32)
        lib = native.load_arena_ops()
        if lib is not None:
            row = self.kf_point_idx[kf]
            lib.erase_keyframe_observations(
                kf, native.as_i32p(row), row.shape[0],
                native.as_i32p(self.pt_obs_kf), native.as_i32p(self.pt_obs_feat),
                native.as_i32p(self.pt_obs_count), self.cap.max_obs_per_point,
            )
        else:
            pids = self.kf_point_idx[kf]
            for f in np.nonzero(pids >= 0)[0]:
                self._remove_observation(int(pids[f]), kf)
            self.kf_point_idx[kf] = -1
        self.kf_valid[kf] = False

    # ------------------------------------------------------------------ points

    def add_point(
        self,
        pos: np.ndarray,
        desc: np.ndarray,
        first_kf: int,
        normal: np.ndarray,
        min_dist: float,
        max_dist: float,
    ) -> int:
        p = self.num_pts
        if p >= self.cap.max_map_points:
            raise RuntimeError("map-point arena full — raise CapacityConfig.max_map_points")
        self.pt_pos[p] = pos
        self.pt_valid[p] = True
        self.pt_desc[p] = desc
        self.pt_normal[p] = normal
        self.pt_min_dist[p] = min_dist
        self.pt_max_dist[p] = max_dist
        self.pt_first_kf[p] = first_kf
        self.pt_n_visible[p] = 1
        self.pt_n_found[p] = 1
        self.num_pts = p + 1
        return p

    def add_points(
        self,
        pos: np.ndarray,       # (n, 3)
        desc: np.ndarray,      # (n, 8) uint32
        first_kf: int,
        normal: np.ndarray,    # (n, 3)
        min_dist: np.ndarray,  # (n,)
        max_dist: np.ndarray,  # (n,)
    ) -> np.ndarray:
        """Vectorized add_point: allocates n consecutive slots, returns (n,) pids."""
        n = len(pos)
        p = self.num_pts
        if p + n > self.cap.max_map_points:
            raise RuntimeError("map-point arena full — raise CapacityConfig.max_map_points")
        sl = slice(p, p + n)
        self.pt_pos[sl] = pos
        self.pt_valid[sl] = True
        self.pt_desc[sl] = desc
        self.pt_normal[sl] = normal
        self.pt_min_dist[sl] = min_dist
        self.pt_max_dist[sl] = max_dist
        self.pt_first_kf[sl] = first_kf
        self.pt_n_visible[sl] = 1
        self.pt_n_found[sl] = 1
        self.num_pts = p + n
        return np.arange(p, p + n, dtype=np.int32)

    def associate_batch(self, kfs: np.ndarray, feats: np.ndarray, pids: np.ndarray) -> None:
        """Vectorized associate() for DISTINCT pids (each pid at most once per call):
        binds kf feature -> point and appends one observation per row."""
        kfs = np.broadcast_to(np.asarray(kfs), pids.shape)
        feats = np.asarray(feats)
        self.kf_point_idx[kfs, feats] = pids
        counts = self.pt_obs_count[pids]
        ok = counts < self.cap.max_obs_per_point
        self.pt_obs_kf[pids[ok], counts[ok]] = kfs[ok]
        self.pt_obs_feat[pids[ok], counts[ok]] = feats[ok]
        self.pt_obs_count[pids[ok]] = counts[ok] + 1

    def erase_point(self, pid: int) -> None:
        """MapPoint::SetBadFlag equivalent: detach from all keyframes, mark invalid."""
        for s in range(int(self.pt_obs_count[pid])):
            kf, f = self.pt_obs_kf[pid, s], self.pt_obs_feat[pid, s]
            if kf >= 0 and self.kf_point_idx[kf, f] == pid:
                self.kf_point_idx[kf, f] = -1
        self.pt_obs_kf[pid] = -1
        self.pt_obs_feat[pid] = -1
        self.pt_obs_count[pid] = 0
        self.pt_valid[pid] = False

    def remove_observations_batch(self, pids: np.ndarray, kfs: np.ndarray) -> None:
        """Vectorized _remove_observation over (pid, kf) pairs (pids may repeat
        with different kfs). Does NOT touch kf_point_idx bindings — callers unbind
        first (they know which feature row to clear)."""
        if len(pids) == 0:
            return
        pids = np.asarray(pids, np.int64)
        kfs = np.asarray(kfs, np.int64)
        upids = np.unique(pids)
        K = np.int64(self.cap.max_keyframes)
        obs_kf = self.pt_obs_kf[upids]                      # (n, O) int32
        keys = upids[:, None] * K + obs_kf                  # unique per (pid, kf)
        rm_keys = pids * K + kfs
        has = obs_kf >= 0
        keep = has & ~np.isin(keys, rm_keys)
        # stable-compact kept slots to the front of each row
        order = np.argsort(~keep, axis=1, kind="stable")
        new_kf = np.take_along_axis(obs_kf, order, axis=1)
        new_ft = np.take_along_axis(self.pt_obs_feat[upids], order, axis=1)
        cnt = keep.sum(axis=1).astype(np.int32)
        col = np.arange(obs_kf.shape[1], dtype=np.int32)[None, :] < cnt[:, None]
        self.pt_obs_kf[upids] = np.where(col, new_kf, -1)
        self.pt_obs_feat[upids] = np.where(col, new_ft, -1)
        self.pt_obs_count[upids] = cnt

    def erase_points_batch(self, pids: np.ndarray) -> None:
        """Vectorized erase_point: detach every observation of each pid from its
        keyframe binding row, clear the obs tables, mark invalid."""
        if len(pids) == 0:
            return
        pids = np.asarray(pids, np.int64)
        obs_kf = self.pt_obs_kf[pids]
        obs_ft = self.pt_obs_feat[pids]
        has = obs_kf >= 0
        k = obs_kf[has].astype(np.int64)
        f = obs_ft[has].astype(np.int64)
        owner = np.repeat(pids, has.sum(axis=1))  # row-major like obs_kf[has]
        match = self.kf_point_idx[k, f] == owner
        self.kf_point_idx[k[match], f[match]] = -1
        self.pt_obs_kf[pids] = -1
        self.pt_obs_feat[pids] = -1
        self.pt_obs_count[pids] = 0
        self.pt_valid[pids] = False

    def _add_observation(self, pid: int, kf: int, feat: int) -> None:
        c = int(self.pt_obs_count[pid])
        if c >= self.cap.max_obs_per_point:
            return  # capped fan-in; oldest observations win (stable anchors)
        self.pt_obs_kf[pid, c] = kf
        self.pt_obs_feat[pid, c] = feat
        self.pt_obs_count[pid] = c + 1

    def _remove_observation(self, pid: int, kf: int) -> None:
        c = int(self.pt_obs_count[pid])
        slots = self.pt_obs_kf[pid, :c]
        keep = slots != kf
        kept_kf = slots[keep]
        kept_ft = self.pt_obs_feat[pid, :c][keep]
        self.pt_obs_kf[pid, : len(kept_kf)] = kept_kf
        self.pt_obs_feat[pid, : len(kept_ft)] = kept_ft
        self.pt_obs_kf[pid, len(kept_kf) : c] = -1
        self.pt_obs_feat[pid, len(kept_ft) : c] = -1
        self.pt_obs_count[pid] = len(kept_kf)
        # auto-delete at <= 2 observations like the reference (map_point.cpp:127-153)
        # is handled by callers (culling), since during construction low counts are normal.

    def associate(self, kf: int, feat: int, pid: int) -> None:
        """Bind keyframe feature -> point and register the observation."""
        self.kf_point_idx[kf, feat] = pid
        self._add_observation(pid, kf, feat)

    def merge_points(self, keep: int, kill: int) -> None:
        """MapPoint::Replace (map_point.cpp:190-226): fold `kill` into `keep`.

        Every observation of `kill` is re-bound to `keep` unless that keyframe
        already observes `keep` (then the duplicate feature is detached);
        visible/found counters accumulate."""
        if keep == kill or not self.pt_valid[kill]:
            return
        lib = native.load_arena_ops()
        if lib is not None:
            lib.merge_points(
                keep, kill,
                native.as_i32p(self.kf_point_idx), self.kf_point_idx.shape[1],
                native.as_i32p(self.pt_obs_kf), native.as_i32p(self.pt_obs_feat),
                native.as_i32p(self.pt_obs_count),
                native.as_i32p(self.pt_n_visible), native.as_i32p(self.pt_n_found),
                native.as_u8p(self.pt_valid), self.cap.max_obs_per_point,
            )
            return
        keep_kfs = set(
            int(k) for k in self.pt_obs_kf[keep, : int(self.pt_obs_count[keep])]
        )
        for s in range(int(self.pt_obs_count[kill])):
            kf, f = int(self.pt_obs_kf[kill, s]), int(self.pt_obs_feat[kill, s])
            if kf < 0:
                continue
            if kf in keep_kfs:
                if self.kf_point_idx[kf, f] == kill:
                    self.kf_point_idx[kf, f] = -1
            else:
                self.kf_point_idx[kf, f] = keep
                self._add_observation(keep, kf, f)
                keep_kfs.add(kf)
        self.pt_n_visible[keep] += self.pt_n_visible[kill]
        self.pt_n_found[keep] += self.pt_n_found[kill]
        self.pt_obs_kf[kill] = -1
        self.pt_obs_feat[kill] = -1
        self.pt_obs_count[kill] = 0
        self.pt_valid[kill] = False

    # ------------------------------------------------------------------ derived

    def covisibility_counts(self, kf: int) -> np.ndarray:
        """Shared-point counts between `kf` and every other keyframe.

        Replaces KeyFrame::UpdateConnections (keyframe.cpp:190-275): derived from the
        observation table instead of stored edges.
        """
        counts = np.zeros(self.num_kfs, np.int64)
        lib = native.load_arena_ops()
        if lib is not None:
            row = self.kf_point_idx[kf]
            lib.covisibility_counts(
                kf, native.as_i32p(row), row.shape[0],
                native.as_i32p(self.pt_obs_kf), native.as_i32p(self.pt_obs_count),
                self.cap.max_obs_per_point, native.as_i64p(counts), self.num_kfs,
            )
        else:
            pids = self.kf_point_idx[kf]
            pids = pids[pids >= 0]
            if len(pids) == 0:
                return counts
            obs_kfs = self.pt_obs_kf[pids]  # (n, O)
            flat = obs_kfs[obs_kfs >= 0]
            if len(flat):
                bc = np.bincount(flat, minlength=self.num_kfs)
                counts[: len(bc)] = bc[: self.num_kfs]
            counts[kf] = 0
        counts[~self.kf_valid[: self.num_kfs]] = 0
        return counts

    def covisible_keyframes(self, kf: int, min_shared: int = 15, max_n: int = 0) -> np.ndarray:
        """Ids of keyframes sharing >= min_shared points, sorted by weight desc."""
        counts = self.covisibility_counts(kf)
        ids = np.nonzero(counts >= min_shared)[0]
        ids = ids[np.argsort(-counts[ids], kind="stable")]
        if max_n:
            ids = ids[:max_n]
        return ids

    def effective_kf_pose(self, kf: int) -> np.ndarray:
        """(4,4) float64 Tcw of `kf`, composing through the spanning-tree parent
        chain when the keyframe was culled: Tcw_eff = Tcp_chain @ Tcw_live_ancestor
        (SaveTrajectoryKITTI semantics, slam_system.cpp:283-296). Falls back to the
        frozen pose when no live ancestor exists."""
        if self.kf_valid[kf] or self.kf_parent is None:
            return self.kf_pose[kf].astype(np.float64)
        rel = np.eye(4)
        k = kf
        for _ in range(self.num_kfs):  # chain is acyclic; bound for safety
            if self.kf_valid[k]:
                return rel @ self.kf_pose[k].astype(np.float64)
            p = int(self.kf_parent[k])
            if p < 0:
                break
            rel = rel @ self.kf_rel_to_parent[k].astype(np.float64)
            k = p
        return self.kf_pose[kf].astype(np.float64)

    def point_found_ratio(self, pid) -> np.ndarray:
        return self.pt_n_found[pid] / np.maximum(self.pt_n_visible[pid], 1)

    # Stats
    @property
    def n_valid_kfs(self) -> int:
        return int(self.kf_valid[: self.num_kfs].sum())

    @property
    def n_valid_pts(self) -> int:
        return int(self.pt_valid[: self.num_pts].sum())
