"""Monocular tracking stage: two-view bootstrap + scale-normalized tracking.

Port of slam_framework_tpu/pipeline/mono_tracker.py: MonocularInitialization
(src/core/tracker.cpp:297-364), CreateInitialMapMonocular (:366-460),
SearchForInitialization (src/orb_features/orb_matcher.cpp:264-382) and the mono
keyframe policy (:1271-1278: ref-ratio 0.9, no stereo close-point logic).

The whole stereo tracking machine (pipeline/tracker.py) is reused. A staged
monocular frame is ONE (1, H, W) uint8 image, and the front-end extracts from
its 8 level images in one FAST+NMS launch: the reference's chunk program is fed
the image twice and drops the second copy (its `_MonoChunkFrontend`); here the
second copy is never staged. With no stereo head u_right / depth are -1, so
every residual downstream takes the 2-dof mono form, keyframe creation spawns no
depth point, and the local mapper runs synchronously and supplies the new
landmarks by triangulation. The map's scale is fixed by normalizing the initial
map's median depth to 1 (tracker.cpp:417-438) and is observable only up to the
gauge: trajectories are evaluated Sim3-aligned (io/trajectory.py).

The initializer's (200, 8) RANSAC sets are drawn on the host from a
`torch.Generator` seeded 3, one draw per two-view attempt (`_draw_sets`; the
reference splits `PRNGKey(3)` per attempt).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from slam_framework_torch.config import SlamConfig
from slam_framework_torch.geometry import se3
from slam_framework_torch.map.arena import MapArena
from slam_framework_torch.matching import hamming, matcher
from slam_framework_torch.optim import global_ba
from slam_framework_torch.pipeline.frame import MonoFrontend
from slam_framework_torch.pipeline.tracker import DeviceTrackState, FrameRecord, StereoTracker
from slam_framework_torch.solvers import initializer


class MonoTracker(StereoTracker):
    MIN_INIT_MATCHES = 100      # tracker.cpp:310,331
    INIT_WINDOW_PX = 100.0      # SearchForInitialization window (tracker.cpp:308)
    MAX_KFS_PER_CHUNK = 2       # mono needs rapid keyframe insertion after the bootstrap
    frontend_images = 1         # one (1, H, W) uint8 image per staged frame

    def __init__(self, cfg: SlamConfig, arena: Optional[MapArena] = None, sync_every: int = 4,
                 device: Optional[torch.device] = None):
        if cfg.sensor != "monocular":
            raise ValueError(f"MonoTracker needs sensor 'monocular', not {cfg.sensor!r}")
        super().__init__(cfg, arena, sync_every=sync_every, device=device)
        self._init_ref: Optional[dict] = None
        self._gen = torch.Generator().manual_seed(3)
        # the reference extracts 2x features while uninitialized (tracker.cpp:84-90);
        # only this init-path front-end is doubled, tracking keeps its 1x shapes
        self._init_frontend = MonoFrontend(cfg, feature_multiplier=2)
        self.last_init: Optional[dict] = None  # the successful two-view initialization

    def _make_frontend(self):
        return MonoFrontend(self.cfg)

    def _current_sync(self) -> int:
        """Short chunks until the map matures: a 2-view bootstrap map (~150
        points) loses tracking within 4 frames without a keyframe refresh."""
        return min(2, self.sync_every) if self.arena.n_valid_kfs < 8 else self.sync_every

    def track_image(self, img: np.ndarray, timestamp: float) -> Optional[np.ndarray]:
        """Feed one grayscale image from a HOST array."""
        return self.track_device(torch.from_numpy(np.asarray(img))[None].to(self.device), timestamp)

    # ------------------------------------------------------------------ init

    def _draw_sets(self, mask: np.ndarray) -> torch.Tensor:
        """One draw of the initializer's (200, 8) match-index sets."""
        return initializer.sample_hypotheses(torch.from_numpy(mask), self._gen)

    def _init_match(self, ref_xy, ref_desc, ref_valid, ref_angle, cur):
        """SearchForInitialization (orb_matcher.cpp:264-382): window search around
        the reference feature positions + ratio + rotation consistency."""
        ham = hamming.hamming_matrix(ref_desc, cur.desc)
        radius = torch.full((ref_xy.shape[0],), self.INIT_WINDOW_PX, dtype=torch.float32, device=ref_xy.device)
        gate = matcher.window_gate(ref_xy, cur.xy, radius) & ref_valid[:, None] & cur.valid[None, :]
        res = matcher.gated_match(ham, gate, max_dist=50, nn_ratio=0.9, mutual=True)
        res = matcher.rotation_consistency(ref_angle, cur.angle, res)
        res = matcher.resolve_duplicate_columns(res, cur.xy.shape[0])
        return res.idx, res.valid

    def _initialize(self, frame: torch.Tensor, timestamp) -> bool:
        fd = self._init_frontend(frame[0])  # 2x features (tracker.cpp:84-90)
        host = {k: getattr(fd, k).cpu().numpy() for k in ("xy", "desc", "valid", "octave", "angle")}
        host["desc"] = host["desc"].view(np.uint32)
        if self._init_ref is None:
            if int(host["valid"].sum()) > self.cfg.tracker.min_init_features // 5:  # >100 (tracker.cpp:301)
                self._init_ref = {**host, "frame_id": self.frame_id, "ts": timestamp}
            return False
        ref = self._init_ref
        dev = self.device

        def put(a):
            a = np.ascontiguousarray(a)
            return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(dev)

        idx_d, val_d = self._init_match(put(ref["xy"]), put(ref["desc"]), put(ref["valid"]), put(ref["angle"]), fd)
        idx, valid = idx_d.cpu().numpy(), val_d.cpu().numpy()
        rows = np.nonzero(valid)[0]
        if len(rows) < self.MIN_INIT_MATCHES:
            self._init_ref = {**host, "frame_id": self.frame_id, "ts": timestamp}
            return False

        N = ref["xy"].shape[0]
        uv1 = np.zeros((N, 2), np.float32)
        uv2 = np.zeros((N, 2), np.float32)
        m = np.zeros(N, bool)
        uv1[: len(rows)] = ref["xy"][rows]
        uv2[: len(rows)] = host["xy"][idx[rows]]
        m[: len(rows)] = True
        res = initializer.initialize_two_view(put(uv1), put(uv2), put(m), self.K, self._draw_sets(m))
        if not bool(res.ok):
            # ambiguous motion / too little parallax: both the E path and the
            # planar H path rejected the pair; keep trying like the reference
            return False
        R, t, pts, good = (x.cpu().numpy() for x in (res.R, res.t, res.points, res.good))
        return self._create_initial_map(ref, host, rows, idx, R, t, pts, good, timestamp)

    @staticmethod
    def _compact_init_features(ref, cur, rows, idx, n_cap):
        """Compact the 2x-budget init feature sets to the arena's per-keyframe row
        capacity: matched pairs first (kept 1:1), then the strongest remaining
        valid features. Returns the remapped (ref, cur, rows, idx) with
        rows = arange(n_m) and idx[rows] = arange(n_m)."""
        n_m = len(rows)
        ref_rest = np.setdiff1d(np.nonzero(ref["valid"])[0], rows)[: n_cap - n_m]
        ref_keep = np.concatenate([rows, ref_rest])
        cur_matched = idx[rows]
        cur_rest = np.setdiff1d(np.nonzero(cur["valid"])[0], cur_matched)[: n_cap - n_m]
        cur_keep = np.concatenate([cur_matched, cur_rest])

        def pad_to(d, keep):
            out = {}
            for k, v in d.items():
                if isinstance(v, np.ndarray) and v.shape[:1] == d["valid"].shape:
                    row = v[keep]
                    if len(row) < n_cap:
                        row = np.concatenate([row, np.zeros((n_cap - len(row),) + row.shape[1:], row.dtype)])
                    out[k] = row
                else:
                    out[k] = v
            return out

        ref2 = pad_to(ref, ref_keep)
        cur2 = pad_to(cur, cur_keep)
        ref2["valid"][len(ref_keep):] = False
        cur2["valid"][len(cur_keep):] = False
        new_idx = np.full(n_cap, -1, np.int64)
        new_idx[:n_m] = np.arange(n_m)
        return ref2, cur2, np.arange(n_m), new_idx

    def _create_initial_map(self, ref, cur, rows, idx, R, t, pts, good, timestamp) -> bool:
        """CreateInitialMapMonocular (tracker.cpp:366-460): two keyframes, the
        triangulated points, a 20-iteration global BA, median depth normalized to 1."""
        arena = self.arena
        cfg = self.cfg
        n_cap = arena.kf_xy.shape[1]
        if ref["xy"].shape[0] > n_cap:
            # pts / good stay aligned: they are indexed by match slot, and the
            # matched pairs keep their order at the front
            ref, cur, rows, idx = self._compact_init_features(ref, cur, rows, idx, n_cap)
        N = ref["xy"].shape[0]
        pose1 = np.eye(4, dtype=np.float32)
        pose2 = np.eye(4, dtype=np.float32)
        pose2[:3, :3] = R
        pose2[:3, 3] = t
        no_depth = np.full(N, -1.0, np.float32)
        kf1 = arena.add_keyframe(pose1, ref["frame_id"], ref["ts"], ref["xy"], no_depth, no_depth,
                                 ref["octave"].astype(np.int16), ref["angle"], ref["desc"], ref["valid"],
                                 np.full(N, -1, np.int32))
        kf2 = arena.add_keyframe(pose2, self.frame_id, timestamp, cur["xy"], no_depth, no_depth,
                                 cur["octave"].astype(np.int16), cur["angle"], cur["desc"], cur["valid"],
                                 np.full(N, -1, np.int32))
        sf = cfg.orb.scale_factor
        point_ids2 = np.full(N, -1, np.int32)
        match_slot = np.zeros(N, np.int32)  # compact match index per ref feature
        match_slot[rows] = np.arange(len(rows))
        for f1 in rows:
            slot = match_slot[f1]
            if not good[slot]:
                continue
            f2 = int(idx[f1])
            pos = pts[slot]
            dist = float(np.linalg.norm(pos))
            if dist < 1e-6:
                continue
            max_dist = dist * (sf ** float(cur["octave"][f2]))
            pid = arena.add_point(pos.astype(np.float32), cur["desc"][f2], kf2, (pos / dist).astype(np.float32),
                                  max_dist / (sf ** (cfg.orb.num_levels - 1)), max_dist)
            arena.associate(kf1, int(f1), pid)
            arena.associate(kf2, f2, pid)
            point_ids2[f2] = pid
        if arena.n_valid_pts < self.MIN_INIT_MATCHES // 2:
            self._wipe_init(kf1, kf2)
            return False

        # 20-iteration full BA over the 2-view map (tracker.cpp:414)
        global_ba.run_global_ba(arena, cfg, self.K, iters=(0, 20), device=self.local_mapper.device)

        # median-depth normalization (tracker.cpp:417-438)
        pids = np.nonzero(arena.pt_valid[: arena.num_pts])[0]
        z1 = arena.pt_pos[pids] @ arena.kf_pose[kf1][:3, :3].T[:, 2] + arena.kf_pose[kf1][2, 3]
        med = float(np.median(z1))
        if med <= 0 or arena.n_valid_pts < self.MIN_INIT_MATCHES // 2:
            self._wipe_init(kf1, kf2)
            return False
        inv_med = 1.0 / med
        arena.pt_pos[pids] *= inv_med
        for k in (kf1, kf2):
            arena.kf_pose[k][:3, 3] *= inv_med

        # the device tracking state from the CURRENT frame
        self.ref_kf = kf2
        self.local_mapper.note_new_points(pids, kf2)
        self._rebuild_block()
        slot = self._ids_to_slots(point_ids2)
        # per-frame velocity from the init baseline: exp(log(T_2<-1) / gap)
        gap = max(int(self.frame_id - ref["frame_id"]), 1)
        T21 = arena.kf_pose[kf2] @ np.linalg.inv(arena.kf_pose[kf1])
        vel0 = se3.se3_exp(se3.se3_log(torch.from_numpy(T21)) / gap).numpy().astype(np.float32)
        dev = self.device
        self._dstate = DeviceTrackState(
            pose=torch.from_numpy(arena.kf_pose[kf2].copy()).to(dev),
            velocity=torch.from_numpy(vel0).to(dev),
            desc=torch.from_numpy(cur["desc"].view(np.int32)).to(dev),
            octave=torch.from_numpy(cur["octave"].astype(np.int32)).to(dev),
            angle=torch.from_numpy(cur["angle"]).to(dev),
            pt_pos=torch.from_numpy(self._block_pos_for_slots(slot)).to(dev),
            pt_mask=torch.from_numpy(slot >= 0).to(dev),
            assoc_slot=torch.from_numpy(slot).to(dev),
        )
        eye = np.eye(4, dtype=np.float64)
        self.records.append(FrameRecord(ref["frame_id"], ref["ts"], np.eye(4, dtype=np.float32), False, kf1, eye))
        self.records.append(FrameRecord(self.frame_id, timestamp, arena.kf_pose[kf2].copy(), False, kf2, eye))
        self.ref_kf_tracked = int((point_ids2 >= 0).sum())
        self.last_kf_frame_id = self.frame_id
        self._init_ref = None
        self.last_init = {"frame": self.frame_id, "ref_frame": ref["frame_id"], "points": len(pids),
                          "median_depth": float(np.median(z1 * inv_med))}
        self.metrics.add(event="mono_init", **self.last_init)
        if self.on_new_keyframe:
            self.on_new_keyframe(kf1)
            self.on_new_keyframe(kf2)
        return True

    def _wipe_init(self, kf1: int, kf2: int) -> None:
        """Failed bootstrap (median depth <= 0 / too few points, tracker.cpp:420-424):
        clear the partial map, keep trying with a fresh reference."""
        arena = self.arena
        for pid in range(arena.num_pts):
            if arena.pt_valid[pid]:
                arena.erase_point(pid)
        arena.erase_keyframe(kf1)
        arena.erase_keyframe(kf2)
        arena.num_kfs = 0
        arena.num_pts = 0
        self._init_ref = None

    # ------------------------------------------------------------------ keyframe policy

    def _need_new_keyframe(self, fid: int, s: np.ndarray) -> bool:
        """Mono variant (tracker.cpp:1271-1278): ref-ratio 0.9, no close-point logic."""
        cfg = self.cfg
        n_inliers = int(s[17])
        if n_inliers < 15:
            return False
        frames_since = fid - self.last_kf_frame_id
        under_ratio = n_inliers < self._ref_kf_tracked_strong() * 0.9
        overdue = frames_since >= cfg.max_frames_between_kfs
        return overdue or (
            under_ratio
            and frames_since >= max(cfg.min_frames_between_kfs, 1)
            and n_inliers > 15
        )
