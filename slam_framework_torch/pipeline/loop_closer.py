"""Loop-closing stage: BoW detection -> Sim3 verification -> correction + pose graph.

Port of slam_framework_tpu/pipeline/loop_closer.py, after the LoopCloser
thread (src/core/loop_closer.{h,cpp}): DetectLoop with
covisibility-consistency voting (:194-297), ComputeSim3 (:299-469),
CorrectLoop (Sim3 propagation to the covisible group, fusion,
essential-graph optimisation, :501-695) and the follow-up global BA
(:73-172).

The stage is sequenced by the host (it runs per keyframe) and every heavy step
is one batched device program: the vocabulary descent (bow/vocabulary.py),
descriptor matching (matching/hamming.py), batched-hypothesis Horn Sim3 RANSAC
(solvers/sim3solver.py), Sim3-guided projection matching, the Sim3 pose graph
(optim/pose_graph.py) and the global BA (optim/global_ba.py). The programs
gather keyframe features by index from a device-resident store
(pipeline/kf_store.py): the mapper's when the caller hands it over, a private
one otherwise. A BoW transform is fetched one keyframe after it was enqueued
and the global BA at a later keyframe (`apply_pending_gba`): neither is waited
for where it is launched.

Given a rank mesh of more than one rank (`mesh=`, parallel/mesh.py), the
post-loop global BA runs as one SPMD program over it: points are dealt to the
ranks by covisibility segment (parallel/map_shard.py), each rank reduces its
landmark blocks and the camera system is summed across the ranks
(parallel/dist_ba.py); after the merge, point ownership is recomputed and the
moved rows are re-dealt with one all_to_all. A mesh of one rank takes the
single-device path.

Not carried over: the fetch registry that folds the BoW transform into the
tracker's drain and the shared program cache.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from slam_framework_torch import resolve_device
from slam_framework_torch.bow import vocabulary as bow_vocab
from slam_framework_torch.bow.database import BowFrame, KeyframeDatabase
from slam_framework_torch.config import SlamConfig
from slam_framework_torch.geometry.projection import Intrinsics
from slam_framework_torch.map.arena import MapArena
from slam_framework_torch.matching import hamming, matcher
from slam_framework_torch.optim import global_ba, pose_graph
from slam_framework_torch.parallel import dist_ba, map_shard
from slam_framework_torch.parallel.mesh import RankMesh, canonical_device
from slam_framework_torch.pipeline import track_ops
from slam_framework_torch.pipeline.kf_store import DeviceKFStore
from slam_framework_torch.solvers import sim3solver

N_HYPOTHESES = 256  # Sim3 RANSAC triplets per attempt


# ----------------------------------------------------------------- host Sim3 helpers
# Tiny numpy Sim3 ops for the host-side correction bookkeeping (the device-side
# counterparts live in geometry/sim3.py; these need no device round trip).

def np_sim3(R: np.ndarray, t: np.ndarray, s: float):
    return {"R": np.asarray(R, np.float64), "t": np.asarray(t, np.float64), "s": float(s)}


def np_sim3_from_se3(T: np.ndarray):
    return np_sim3(T[:3, :3], T[:3, 3], 1.0)


def np_sim3_compose(A, B):
    return np_sim3(A["R"] @ B["R"], A["s"] * (A["R"] @ B["t"]) + A["t"], A["s"] * B["s"])


def np_sim3_inverse(S):
    Rt = S["R"].T
    return np_sim3(Rt, -(Rt @ S["t"]) / S["s"], 1.0 / S["s"])


def np_sim3_apply(S, pts: np.ndarray) -> np.ndarray:
    return S["s"] * (pts @ S["R"].T) + S["t"]


def np_sim3_to_se3(S) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = S["R"]
    T[:3, 3] = S["t"] / S["s"]
    return T


class LoopCandidate(NamedTuple):
    kf: int
    Scl: dict              # host Sim3: loop-KF camera frame -> current camera frame
    n_inliers: int


class _CovisMap:
    """Lazy covisibility-group lookup for KeyframeDatabase voting."""

    def __init__(self, arena: MapArena, min_shared: int):
        self.arena = arena
        self.min_shared = min_shared

    def get(self, kf, default=None):
        ids = self.arena.covisible_keyframes(int(kf), min_shared=self.min_shared)
        return [int(kf)] + [int(i) for i in ids]



class LoopCloser:
    """Per-keyframe loop detection and correction over the array map."""

    def __init__(
        self,
        cfg: SlamConfig,
        arena: MapArena,
        K: Intrinsics,
        vocab: Optional[bow_vocab.Vocabulary] = None,
        kf_store: Optional[DeviceKFStore] = None,
        device=None,
        mesh: Optional[RankMesh] = None,
    ):
        """device: where the stage's programs run. None means the device of
        `kf_store` when one is given, else the first CUDA device (raising when
        there is none); the CPU only when the caller passes it.

        mesh: a rank mesh on that device; with more than one rank the
        post-loop global BA runs sharded over it and point ownership migrates
        after each merge. A mesh on another device raises."""
        self.cfg = cfg
        self.arena = arena
        self.K = K
        self.vocab = vocab
        if device is None and kf_store is not None:
            device = kf_store.device
        self.device = resolve_device(device)
        if mesh is not None and canonical_device(mesh.device) != canonical_device(self.device):
            raise ValueError(f"the mesh {mesh!r} is not on the loop closer's device {self.device}")
        self.mesh = mesh
        self.partition: Optional[map_shard.MapPartition] = None  # the live map partition
        # Device-resident keyframe feature store: BoW, descriptor matching and
        # the Sim3-guided programs gather keyframe features by INDEX
        self.kf_store = kf_store if kf_store is not None else DeviceKFStore(
            cfg.capacity.max_keyframes, arena.kf_xy.shape[1], device=self.device
        )
        self.db = KeyframeDatabase(vocab.num_words if vocab else 0)
        self.bow_frames: dict[int, BowFrame] = {}
        self.consistent_groups: List[Tuple[set, int]] = []
        self.last_loop_kf = -(10**9)
        # Sim3-failure cooldown (a host-side gate): a failed candidate's
        # covisibility group is suppressed for cfg.loop.sim3_fail_cooldown
        # keyframes (0 = always retry, the reference's behaviour)
        self._sim3_failed: List[Tuple[set, int]] = []  # (group, failed_at_kf)
        self.n_sim3_attempts = 0
        self.loop_edges: List[Tuple[int, int, dict]] = []  # (kf_a, kf_b, S_ab host Sim3)
        self.n_loops_closed = 0
        self.last_report: dict = {}
        self.cap_clips: dict = {}
        self._gba_pending = None   # in-flight global BA (see apply_pending_gba)
        # what became of each global BA: {"kf": loop keyframe, "outcome": "merged" | "aborted"}
        self.gba_log: List[dict] = []
        self._bow_pending = None   # (kf, word, weight on the device) awaiting harvest
        # the RANSAC's index sets are drawn on the host, so the card and the
        # CPU test the same hypotheses
        self._gen = torch.Generator().manual_seed(7)
        self._tables = vocab.device_tables(self.device) if vocab else None
        self._fix_scale = cfg.sensor in ("stereo", "rgbd")

    def _put(self, a) -> torch.Tensor:
        """Host array -> the stage's device; uint32 words keep their bits as int32."""
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------------ device programs

    @staticmethod
    def _match_descriptors(desc_a, mask_a, desc_b, mask_b):
        """SearchByBoW(KF, KF) equivalent (orb_matcher.cpp:499-632): mutual best
        Hamming match under TH_LOW with 0.75 nn-ratio over the full matrix
        (the pruning by shared vocabulary nodes only serves a CPU). desc_b /
        mask_b may carry a leading batch of candidates."""
        ham = hamming.hamming_matrix(desc_a, desc_b)
        gate = mask_a[:, None] & mask_b[..., None, :]
        res = matcher.gated_match(ham, gate, max_dist=50, nn_ratio=0.75, mutual=True)
        return res.idx, res.valid

    def _guided_projection_match(self, S_R, S_t, S_s, pts_w, pt_desc, pt_mask, kf_xy, kf_desc, kf_valid):
        """SearchByProjection(Scw) (orb_matcher.cpp:384-497): project world points
        through a Sim3 world->cam, window-gate against keyframe features, Hamming
        match (TH_LOW), per-feature dedup."""
        K = self.K
        pc = S_s * torch.einsum("ni,ji->nj", pts_w, S_R) + S_t[None, :]
        z = torch.where(pc[:, 2] > 1e-6, pc[:, 2], torch.full_like(pc[:, 2], 1e-6))
        uv = torch.stack([K.fx * pc[:, 0] / z + K.cx, K.fy * pc[:, 1] / z + K.cy], dim=-1)
        in_front = pc[:, 2] > 0.05
        W, H = self.cfg.camera.width, self.cfg.camera.height
        in_img = (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) & (uv[:, 1] < H)
        ok = pt_mask & in_front & in_img
        gate = matcher.window_gate(uv, kf_xy, torch.full_like(z, 10.0)) & (ok[:, None] & kf_valid[None, :])
        ham = hamming.hamming_matrix(pt_desc, kf_desc)
        res = matcher.gated_match(ham, gate, max_dist=50)
        res = matcher.resolve_duplicate_columns(res, kf_xy.shape[0])
        return res.idx, res.valid

    def _search_by_sim3(
        self, S_R, S_t, S_s,
        p_c, mask_c, desc_c, xy_c, oct_c, maxd_c,
        p_l, mask_l, desc_l, xy_l, oct_l, maxd_l,
    ):
        """SearchBySim3 (orb_matcher.cpp:1081-1310): widen the Sim3 correspondence
        set by MUTUAL Sim3-guided projection between the two keyframes: loop-KF
        points projected into the current image and vice versa; a pair is accepted
        only when both directions agree (:1288-1300). All aligned with the
        feature slots, one fixed-shape program.

        p_c / p_l: (N, 3) map points in each keyframe's OWN camera frame; masks
        mark features with a (valid, not already matched) point. Returns per
        current feature the loop feature's index (-1 none)."""
        cfg = self.cfg
        sf = cfg.orb.scale_factor
        K = self.K
        W, H = cfg.camera.width, cfg.camera.height

        def half(R, t, s, pts, m_pts, maxd, xy_t, desc_p, desc_t, m_t, oct_t):
            p = s * torch.einsum("ni,ji->nj", pts, R) + t[None, :]
            z = torch.where(p[:, 2] > 1e-6, p[:, 2], torch.full_like(p[:, 2], 1e-6))
            uv = torch.stack([K.fx * p[:, 0] / z + K.cx, K.fy * p[:, 1] / z + K.cy], dim=-1)
            dist = torch.linalg.vector_norm(p, dim=-1)
            lvl = track_ops.predict_scale(dist, maxd, cfg.orb.num_levels, log_sf=float(np.log(sf)))
            radius = 7.5 * sf ** lvl.to(torch.float32)   # orb_matcher.cpp:1161
            gate = (
                matcher.window_gate(uv, xy_t, radius)
                & (m_pts & (p[:, 2] > 0.0))[:, None]
                & m_t[None, :]
                & (uv[:, 0] >= 0)[:, None] & (uv[:, 0] < W)[:, None]
                & (uv[:, 1] >= 0)[:, None] & (uv[:, 1] < H)[:, None]
                # kpLevel in [predicted-1, predicted] (orb_matcher.cpp:1153,1253)
                & (oct_t[None, :] >= lvl[:, None] - 1) & (oct_t[None, :] <= lvl[:, None])
            )
            ham = hamming.hamming_matrix(desc_p, desc_t)
            res = matcher.gated_match(ham, gate, max_dist=100)  # TH_HIGH
            return torch.where(res.valid, res.idx, torch.full_like(res.idx, -1))

        Rt = S_R.T
        # loop -> current (through Scl), current -> loop (through Scl^-1)
        m_lc = half(S_R, S_t, S_s, p_l, mask_l, maxd_l, xy_c, desc_l, desc_c, mask_c, oct_c)
        m_cl = half(Rt, -torch.mv(Rt, S_t) / S_s, 1.0 / S_s, p_c, mask_c, maxd_c,
                    xy_l, desc_c, desc_l, mask_l, oct_l)
        # agreement: current feature i -> loop feature j and j -> i
        j = m_cl
        back = torch.where(j >= 0, m_lc[torch.clamp(j, min=0).long()], torch.full_like(j, -2))
        agreed = back == torch.arange(p_c.shape[0], dtype=back.dtype, device=back.device)
        return torch.where(agreed, j, torch.full_like(j, -1))

    def _guided_match(self, kf: int, S: dict, pts_dev, desc_dev, mask_dev):
        """The guided projection match of world points into keyframe `kf`
        through the host Sim3 S, read back: (idx, valid) numpy arrays."""
        self.kf_store.ensure([kf], self.arena)
        idx, valid = self._guided_projection_match(
            self._put(np.float32(S["R"])), self._put(np.float32(S["t"])), self._put(np.float32(S["s"])),
            pts_dev, desc_dev, mask_dev,
            self.kf_store.packs[kf, :, 0:2], self.kf_store.descs[kf], self._put(self.arena.kf_feat_valid[kf]),
        )
        return idx.cpu().numpy(), valid.cpu().numpy()

    # ------------------------------------------------------------------ BoW bookkeeping

    def _transform(self, kf: int):
        """Enqueue the vocabulary descent of keyframe kf's descriptors: (word, weight) on the device."""
        self.kf_store.ensure([kf], self.arena)
        word, _, weight = bow_vocab.transform(
            self._tables, self.kf_store.descs[kf], self._put(self.arena.kf_feat_valid[kf]),
            depth=self.vocab.depth, k=self.vocab.k,
        )
        return word, weight

    def compute_bow(self, kf: int) -> BowFrame:
        """DBoW2 transform of a keyframe's descriptors (keyframe.cpp:127-137)."""
        word, weight = self._transform(kf)
        return BowFrame(word.cpu().numpy(), weight.cpu().numpy())

    # ------------------------------------------------------------------ main entry

    def has_pending_gba(self) -> bool:
        return self._gba_pending is not None

    def _dispatch_bow(self, kf: int) -> None:
        """Enqueue the BoW transform; it is read back at the NEXT keyframe
        (harvest), so keyframe creation never waits for place recognition.
        The LoopClosing thread's keyframe queue gives the same decoupling
        (loop_closer.cpp:61-85)."""
        self._bow_pending = (kf,) + self._transform(kf)

    def ensure_bow_current(self) -> None:
        """Land the in-flight BoW into the database now (the relocalizer calls
        this before retrieving candidates). When tracking is lost right after a
        keyframe, that keyframe's BoW waits for a harvest at the NEXT keyframe,
        which never comes while lost, and the nearest candidate would be
        invisible. The loop detection of that keyframe is skipped: the
        relocalizer needs the database row only."""
        prev = self._harvest_bow()
        if prev is not None:
            self.db.add(prev[0], prev[1])

    def _harvest_bow(self):
        if self._bow_pending is None:
            return None
        kf, word_d, weight_d = self._bow_pending
        self._bow_pending = None
        if not self.arena.kf_valid[kf]:
            return None  # culled while in flight
        bow = BowFrame(word_d.cpu().numpy(), weight_d.cpu().numpy())
        self.bow_frames[kf] = bow
        return kf, bow

    def _detect_and_close(self, kf: int, bow: BowFrame, pre_close=None) -> bool:
        candidates = self._detect(kf, bow)
        self.db.add(kf, bow)
        if not candidates:
            return False
        # First pass WITHOUT draining the mapper: Sim3 RANSAC + guided
        # acceptance tolerate one local BA of pose/point staleness (mm-cm
        # against the RANSAC's own noise), and on the bench world some fifty
        # consistent candidate sets FAIL here per closed loop; each
        # pre_close() is a blocking fetch of the in-flight BA / triangulation
        # / fusion results. Only a PASSING candidate pays the drain, and is
        # then re-verified + corrected on settled state (CorrectLoop stops the
        # mapper only after ComputeSim3 accepts, loop_closer.cpp:501-524).
        self.n_sim3_attempts += 1
        cand = self._compute_sim3(kf, candidates)
        if cand is not None and pre_close is not None:
            pre_close()  # settle the map, then re-verify on it
            cand = self._compute_sim3(kf, [cand.kf])
        if cand is None:
            # start the failure cooldown for every attempted candidate group
            arena = self.arena
            for c in candidates:
                grp = set(
                    int(i) for i in arena.covisible_keyframes(
                        c, min_shared=self.cfg.mapping.covisibility_edge_min
                    )
                ) | {c}
                self._sim3_failed.append((grp, kf))
            return False
        self._correct_loop(kf, cand)
        self.n_loops_closed += 1
        self.last_loop_kf = kf
        return True

    def process_keyframe(self, kf: int, pre_close=None) -> bool:
        """One step of the loop-closing stage: harvest the PREVIOUS keyframe's
        in-flight BoW and run detection/Sim3/correction for it, then dispatch
        this keyframe's BoW. Detection therefore runs one keyframe late: the
        same bounded lag as the LoopClosing thread consuming its keyframe
        queue (loop_closer.cpp:61-85, 194-297). Returns True if a loop was
        closed (map poses/points were rewritten).

        pre_close: called once, right before Sim3 computation, only when
        detection produced consistent candidates — the caller uses it to drain
        in-flight mapper work (Sim3/correction need settled poses; detection is
        appearance-only and does not)."""
        if self.vocab is None:
            return False
        closed = False
        prev = self._harvest_bow()
        if prev is not None:
            closed = self._detect_and_close(prev[0], prev[1], pre_close=pre_close)
        self._dispatch_bow(kf)
        return closed

    def flush(self, pre_close=None) -> bool:
        """Drain the in-flight BoW (end of sequence / before exports): run the
        deferred detection for the final keyframe."""
        prev = self._harvest_bow()
        if prev is None:
            return False
        return self._detect_and_close(prev[0], prev[1], pre_close=pre_close)

    # ------------------------------------------------------------------ detection

    def _detect(self, kf: int, bow: BowFrame) -> List[int]:
        """DetectLoop (loop_closer.cpp:194-297): BoW candidates below the covisible
        score floor + temporal-consistency voting across keyframes."""
        cfg = self.cfg
        if kf < self.last_loop_kf + cfg.loop.min_kf_gap or kf < cfg.loop.min_kf_gap:
            return []
        arena = self.arena
        covis = arena.covisible_keyframes(kf, min_shared=cfg.mapping.covisibility_edge_min)
        min_score = 1.0
        for c in covis:
            other = self.bow_frames.get(int(c))
            if other is not None:
                min_score = min(min_score, bow.score(other))
        connected = set(int(c) for c in covis) | {kf}
        raw = self.db.detect_loop_candidates(
            bow,
            min_score,
            connected,
            covisibility_groups=_CovisMap(arena, cfg.mapping.covisibility_edge_min),
        )
        if not raw:
            self.consistent_groups = []
            return []
        # consistency voting (loop_closer.cpp:244-296): a candidate's covisibility
        # group must overlap a group seen in N consecutive keyframes
        enough: List[int] = []
        new_groups: List[Tuple[set, int]] = []
        for cand in raw:
            group = set(
                int(i)
                for i in arena.covisible_keyframes(cand, min_shared=cfg.mapping.covisibility_edge_min)
            ) | {cand}
            best_count = 0
            for prev_set, prev_count in self.consistent_groups:
                if group & prev_set:
                    best_count = max(best_count, prev_count + 1)
            new_groups.append((group, best_count))
            if best_count >= cfg.loop.consistency_threshold:
                enough.append(cand)
        self.consistent_groups = new_groups
        # failure cooldown: suppress candidates whose group overlaps one that
        # just failed Sim3 (each attempt pays about five host fetches; a
        # genuine loop's overlap only grows, so a short cooldown merely delays
        # acceptance by <= cooldown keyframes)
        cd = cfg.loop.sim3_fail_cooldown
        if cd > 0 and self._sim3_failed and enough:
            self._sim3_failed = [
                (g, at) for (g, at) in self._sim3_failed if kf - at <= cd
            ]
            cand_group = dict(zip(raw, new_groups))
            kept = []
            for cand in enough:
                grp = cand_group[cand][0]
                if any(grp & g for (g, at) in self._sim3_failed):
                    continue
                kept.append(cand)
            enough = kept
        return enough

    # ------------------------------------------------------------------ Sim3

    def _feature_masks(self, kf: int):
        """(point ids per feature, mask of features holding a live point)."""
        arena = self.arena
        pid = arena.kf_point_idx[kf]
        m = (pid >= 0) & arena.kf_feat_valid[kf]
        m &= np.where(pid >= 0, arena.pt_valid[np.maximum(pid, 0)], False)
        return pid, m

    def _correspondences(self, kf, cand, rows, cols, p_c, p_l):
        """The fixed-shape correspondence set of the Sim3 solver, on the
        device: camera-frame points, pixels, sigma^2 per octave and the mask,
        for current features `rows` matched to loop features `cols`."""
        arena = self.arena
        sf2 = self.cfg.orb.scale_factor ** 2
        N = arena.kf_desc.shape[1]
        n = len(rows)
        pts1 = np.zeros((N, 3), np.float32)
        pts2 = np.zeros((N, 3), np.float32)
        uv1 = np.zeros((N, 2), np.float32)
        uv2 = np.zeros((N, 2), np.float32)
        s2_1 = np.ones(N, np.float32)
        s2_2 = np.ones(N, np.float32)
        m = np.zeros(N, bool)
        pts1[:n] = p_c
        pts2[:n] = p_l
        uv1[:n] = arena.kf_xy[kf, rows]
        uv2[:n] = arena.kf_xy[cand, cols]
        s2_1[:n] = sf2 ** arena.kf_octave[kf, rows].astype(np.float32)
        s2_2[:n] = sf2 ** arena.kf_octave[cand, cols].astype(np.float32)
        m[:n] = True
        return [self._put(a) for a in (pts1, pts2, uv1, uv2, s2_1, s2_2)], m

    def _compute_sim3(self, kf: int, candidates: List[int]) -> Optional[LoopCandidate]:
        """ComputeSim3 (loop_closer.cpp:299-469): descriptor matches -> batched Horn
        RANSAC -> guided-projection acceptance against the loop KF's local points."""
        arena = self.arena
        cfg = self.cfg
        store = self.kf_store
        pid_c, mask_c_np = self._feature_masks(kf)
        mask_c = self._put(mask_c_np)
        T_cw = arena.kf_pose[kf].astype(np.float64)

        # descriptor matching for ALL candidates in one batched program and one
        # fetch (on the bench world several BoW-plausible candidates die here)
        cand_masks = {c: self._feature_masks(c)[1] for c in candidates}
        store.ensure([kf] + list(candidates), arena)
        idx_b, valid_b = self._match_descriptors(
            store.descs[kf], mask_c,
            store.descs[torch.as_tensor(np.asarray(candidates, np.int64), device=store.descs.device)],
            self._put(np.stack([cand_masks[c] for c in candidates])),
        )
        idx_b, valid_b = idx_b.cpu().numpy(), valid_b.cpu().numpy()

        for ci, cand in enumerate(candidates):
            mask_l_np = cand_masks[cand]
            pid_l = arena.kf_point_idx[cand]
            idx, valid = idx_b[ci], valid_b[ci]
            rows = np.nonzero(valid)[0]
            if len(rows) < cfg.loop.sim3_min_inliers:
                continue
            cols = idx[rows]
            # every feature's point in its own camera frame
            T_lw = arena.kf_pose[cand].astype(np.float64)
            pc_cam = (arena.pt_pos[np.maximum(pid_c, 0)] @ T_cw[:3, :3].T) + T_cw[:3, 3]
            pl_cam = (arena.pt_pos[np.maximum(pid_l, 0)] @ T_lw[:3, :3].T) + T_lw[:3, 3]
            corr, m = self._correspondences(kf, cand, rows, cols, pc_cam[rows], pl_cam[cols])
            sets = sim3solver.sample_index_sets(torch.from_numpy(m), N_HYPOTHESES, self._gen)
            res = sim3solver.solve_sim3_ransac(
                *corr, self._put(m), self.K, sets, fix_scale=self._fix_scale,
                min_inliers=cfg.loop.sim3_min_inliers,
            )
            ok, n_inl = bool(res.ok.cpu()), int(res.n_inliers.cpu())
            if not ok:
                continue
            R, t, s = (x.cpu().numpy() for x in (res.R, res.t, res.s))

            # --- SearchBySim3 widening (loop_closer.cpp:414-438): mutual
            # Sim3-guided projection between the two keyframes recovers
            # correspondences BoW missed, then the Sim3 is re-refined on the
            # widened set (OptimizeSim3, accept >= 20). Rescues borderline
            # loops that are BoW-weak but geometry-strong. ---
            maxd_c = np.where(mask_c_np, arena.pt_max_dist[np.maximum(pid_c, 0)], 0.0)
            maxd_l = np.where(mask_l_np, arena.pt_max_dist[np.maximum(pid_l, 0)], 0.0)
            bow_of_c = np.full(len(pid_c), -1, np.int32)
            bow_of_c[rows] = cols
            bow_l = np.zeros(len(pid_l), bool)
            bow_l[cols] = True  # vbAlreadyMatched2 (orb_matcher.cpp:1118-1124)
            sbs = self._search_by_sim3(
                self._put(np.float32(R)), self._put(np.float32(t)), self._put(np.float32(s)),
                self._put(pc_cam.astype(np.float32)), self._put(mask_c_np & (bow_of_c < 0)),
                store.descs[kf], store.packs[kf, :, 0:2], store.packs[kf, :, 4].to(torch.int32),
                self._put(maxd_c.astype(np.float32)),
                self._put(pl_cam.astype(np.float32)), self._put(mask_l_np & ~bow_l),
                store.descs[cand], store.packs[cand, :, 0:2], store.packs[cand, :, 4].to(torch.int32),
                self._put(maxd_l.astype(np.float32)),
            ).cpu().numpy()
            pair_of_c = np.where(bow_of_c >= 0, bow_of_c, sbs)
            rows_w = np.nonzero(pair_of_c >= 0)[0]
            cols_w = pair_of_c[rows_w]
            if len(rows_w) > len(rows):
                # re-refine on the widened correspondence set
                corr_w, mw = self._correspondences(kf, cand, rows_w, cols_w, pc_cam[rows_w], pl_cam[cols_w])
                R2, t2, s2v, _, cnt2 = sim3solver.refine_sim3(
                    self._put(np.float32(R)), self._put(np.float32(t)), self._put(np.float32(s)),
                    *corr_w, self._put(mw), self.K, fix_scale=self._fix_scale,
                )
                if int(cnt2.cpu()) >= cfg.loop.sim3_min_inliers:
                    R, t, s, n_inl = R2.cpu().numpy(), t2.cpu().numpy(), float(s2v.cpu()), int(cnt2.cpu())
            Scl = np_sim3(R, t, float(s))

            # guided acceptance: project the loop KF's local map through the
            # corrected S_cw into the current KF (loop_closer.cpp:441-468)
            S_lw = np_sim3_from_se3(T_lw.astype(np.float32))
            S_cw_corr = np_sim3_compose(Scl, S_lw)
            loop_pts, loop_desc, _ = self._local_points_of(cand)
            n_total = self._count_guided_matches(kf, S_cw_corr, loop_pts, loop_desc)
            self.last_report = {
                "candidate": int(cand), "sim3_inliers": int(n_inl),
                "guided_matches": int(n_total),
            }
            if n_total >= cfg.loop.accept_total_matches:
                return LoopCandidate(kf=int(cand), Scl=Scl, n_inliers=int(n_inl))
        return None

    def _local_points_of(self, kf: int, cap: int = 4096):
        """World positions + descriptors of kf's and its covisible KFs' points."""
        arena = self.arena
        kfs = [kf] + [
            int(i)
            for i in arena.covisible_keyframes(kf, min_shared=self.cfg.mapping.covisibility_edge_min)
        ]
        pids = arena.kf_point_idx[np.asarray(kfs, np.int64)].reshape(-1)
        pids = np.unique(pids[pids >= 0])
        pids = pids[arena.pt_valid[pids]]
        if len(pids) > cap:
            # cap visibility (VERDICT r2 Weak #6): keep best-observed, count clip
            self.cap_clips["loop_local_points"] = (
                self.cap_clips.get("loop_local_points", 0) + len(pids) - cap
            )
            pids = pids[np.argsort(-arena.pt_obs_count[pids], kind="stable")[:cap]]
        P = cap
        pts = np.zeros((P, 3), np.float32)
        desc = np.zeros((P, 8), np.uint32)
        ids = np.full(P, -1, np.int32)
        pts[: len(pids)] = arena.pt_pos[pids]
        desc[: len(pids)] = arena.pt_desc[pids]
        ids[: len(pids)] = pids
        return pts, desc, ids

    def _count_guided_matches(self, kf: int, S_cw, pts, desc) -> int:
        mask = self._put(np.any(pts != 0, axis=1))
        _, valid = self._guided_match(kf, S_cw, self._put(pts), self._put(desc), mask)
        return int(valid.sum())

    # ------------------------------------------------------------------ correction

    def _correct_loop(self, kf: int, cand: LoopCandidate) -> None:
        """CorrectLoop (loop_closer.cpp:501-695): Sim3-propagate the current
        covisible group, fuse loop points, optimize the essential graph, correct
        all map points."""
        arena = self.arena
        cfg = self.cfg
        loop_kf = cand.kf

        # --- snapshot pre-correction poses for edge measurements ---
        n_kfs = arena.num_kfs
        pre_pose = arena.kf_pose[:n_kfs].copy()

        # --- corrected Sim3 for the current group (loop_closer.cpp:537-585) ---
        group = [kf] + [
            int(i)
            for i in arena.covisible_keyframes(kf, min_shared=cfg.mapping.covisibility_edge_min)
        ]
        T_cw = pre_pose[kf].astype(np.float64)
        S_lw = np_sim3_from_se3(arena.kf_pose[loop_kf])
        S_cw_corr = np_sim3_compose(cand.Scl, S_lw)
        corrected: dict[int, dict] = {}
        non_corrected: dict[int, dict] = {}
        for i in group:
            T_iw = pre_pose[i].astype(np.float64)
            T_ic = T_iw @ np.linalg.inv(T_cw)
            S_ic = np_sim3_from_se3(T_ic.astype(np.float32))
            corrected[i] = np_sim3_compose(S_ic, S_cw_corr)
            non_corrected[i] = np_sim3_from_se3(pre_pose[i])

        # --- move group points + poses (each point corrected once, via its first
        # observing group member) ---
        moved = set()
        for i in group:
            pids = arena.kf_point_idx[i]
            pids = np.unique(pids[pids >= 0])
            pids = [int(p) for p in pids if arena.pt_valid[p] and p not in moved]
            if pids:
                pids_arr = np.asarray(pids, np.int64)
                S_old = non_corrected[i]
                S_new_inv = np_sim3_inverse(corrected[i])
                p = arena.pt_pos[pids_arr].astype(np.float64)
                arena.pt_pos[pids_arr] = np_sim3_apply(
                    S_new_inv, np_sim3_apply(S_old, p)
                ).astype(np.float32)
                moved.update(pids)
            arena.kf_pose[i] = np_sim3_to_se3(corrected[i])

        # --- snapshot the PRE-fuse covisibility structure: the essential graph's
        # spanning-tree/covisibility edges must reflect the odometry-time graph,
        # not the fresh cross-loop links fusion is about to create ---
        pre_covis = {
            i: arena.covisibility_counts(i).copy()
            for i in range(n_kfs)
            if arena.kf_valid[i]
        }
        pre_connected = {
            i: set(np.nonzero(c >= cfg.mapping.covisibility_edge_min)[0].tolist())
            for i, c in pre_covis.items()
        }

        # --- fuse loop points into the corrected group (SearchAndFuse :471-499) ---
        loop_pts, loop_desc, loop_ids = self._local_points_of(loop_kf)
        loop_dev = (self._put(loop_pts), self._put(loop_desc), self._put(loop_ids >= 0))
        n_fused = 0
        for i in group:
            idx, valid = self._guided_match(i, corrected[i], *loop_dev)
            for p_slot in np.nonzero(valid)[0]:
                loop_pid = int(loop_ids[p_slot])
                feat = int(idx[p_slot])
                if loop_pid < 0 or not arena.pt_valid[loop_pid]:
                    continue
                cur_pid = int(arena.kf_point_idx[i, feat])
                if cur_pid >= 0:
                    if arena.pt_valid[cur_pid] and cur_pid != loop_pid:
                        # loop point wins (loop_closer.cpp:492: Replace with pLoopMP)
                        arena.merge_points(loop_pid, cur_pid)
                        n_fused += 1
                else:
                    arena.associate(i, feat, loop_pid)
                    n_fused += 1

        # --- new cross-loop connections created by fusion (CorrectLoop's
        # LoopConnections map, loop_closer.cpp:633-651) ---
        group_set = set(group)
        loop_connections: dict[int, set] = {}
        for i in group:
            now = set(
                np.nonzero(
                    arena.covisibility_counts(i) >= cfg.mapping.covisibility_edge_min
                )[0].tolist()
            )
            loop_connections[i] = now - pre_connected.get(i, set()) - group_set

        # --- loop edge bookkeeping ---
        S_loop_rel = np_sim3_compose(
            corrected[kf], np_sim3_inverse(np_sim3_from_se3(arena.kf_pose[loop_kf]))
        )  # S_c<-l expressed post-correction
        self.loop_edges.append((loop_kf, kf, S_loop_rel))

        # --- essential graph (optimizer.cpp:718-960) ---
        self._optimize_essential_graph(
            kf, loop_kf, pre_pose, corrected, pre_covis, loop_connections
        )

        # --- follow-up global BA (RunGlobalBundleAdjustment, loop_closer.cpp:73-172):
        # asynchronous like that detached thread: enqueued here, tracking
        # continues, and the result is merged at a later keyframe by
        # apply_pending_gba (spanning-tree-style correction for keyframes/points
        # created while it was in flight). A newer loop closure aborts the
        # in-flight result (the stop_global_bundle_adj_ flag).
        if cfg.loop.run_global_ba:
            if self._gba_pending is not None:  # abort the stale in-flight GBA
                self.gba_log.append({"kf": self._gba_pending["kf"], "outcome": "aborted"})
                self._gba_pending = None
            self._dispatch_global_ba(kf)
        self.last_report.update({"fused": n_fused, "group": len(group)})

    # ------------------------------------------------------------------ async global BA

    def _dispatch_global_ba(self, kf: int) -> None:
        """Enqueue the global BA on the device and return: its result is
        fetched by apply_pending_gba at a later keyframe. Nothing between here
        and there reads it back."""
        if self.mesh is not None and self.mesh.size > 1:
            self._dispatch_global_ba_sharded(kf)
            return
        arena = self.arena
        prob, cams, pids = global_ba.build_global_problem(arena, self.cfg, device=self.device)
        res = global_ba.optimize_global(
            prob, K=self.K, iters_first=0, iters_second=self.cfg.loop.global_ba_iters
        )
        self._gba_pending = {
            "kf": kf,
            "res": res,
            "cams": np.asarray(cams),
            "pids": np.asarray(pids),
            "n_kfs": arena.num_kfs,
            "n_pts": arena.num_pts,
        }

    def _dispatch_global_ba_sharded(self, kf: int) -> None:
        """The post-loop global BA as ONE SPMD program over the mesh: points
        are dealt to the ranks by covisibility segment (map_shard.partition_arena),
        each rank reduces its landmark blocks and the camera system is summed
        over the ranks. As asynchronous as the single-device path: the rank
        programs are enqueued when this returns, nothing is read back, and the
        result merges in apply_pending_gba, followed by the migration of point
        ownership."""
        arena, mesh = self.arena, self.mesh
        m = map_shard.shard_map_problem(arena, self.cfg, mesh)
        per_rank = dist_ba.optimize_global_ranks(
            m.sharded, mesh, self.K, iters_first=0, iters_second=self.cfg.loop.global_ba_iters
        )
        self._gba_pending = {
            "kf": kf,
            "res": dist_ba.assemble(mesh, per_rank),
            "cams": m.cams,
            "pids": m.pids,
            "n_kfs": arena.num_kfs,
            "n_pts": arena.num_pts,
            "owner": m.owner,
            "n_shards": mesh.size,
            "partition": m.partition,
            # where the shards and the ranks' results live (no device read)
            "shard_devices": sorted({str(t.device) for t in list(m.sharded) + [t for r in per_rank for t in r]}),
        }

    def apply_pending_gba(self) -> bool:
        """Merge an in-flight global BA into the (possibly grown) map, the
        merge step of RunGlobalBundleAdjustment (loop_closer.cpp:87-171):
        keyframes in the problem adopt the GBA pose; keyframes created while it
        ran are corrected through their strongest covisible parent in the problem
        (spanning-tree child update); points in the problem adopt GBA positions;
        younger points are corrected through their first observing keyframe.
        A sharded result is put back in point order first, and ownership
        migrates after the merge. Returns True if a result was applied."""
        pending = self._gba_pending
        if pending is None:
            return False
        self._gba_pending = None
        arena = self.arena
        res = pending["res"]
        # the one place that waits for the global BA
        new_cam, new_pt, total_chi2 = (t.cpu().numpy() for t in (res.cam_pose, res.pt_pos, res.total_chi2))
        cams, pids = pending["cams"], pending["pids"]
        n_shards = pending.get("n_shards", 1)
        if "owner" in pending:
            new_pt = dist_ba.unshard_points(new_pt, len(pids), n_shards, pending["owner"])
        cam_rank = {int(c): i for i, c in enumerate(cams)}
        n_now = arena.num_kfs

        # 1. post-GBA pose for every live keyframe
        post = {}
        for c, i in cam_rank.items():
            if arena.kf_valid[c]:
                post[c] = new_cam[i].astype(np.float64)
        in_prob = set(post)
        for c in range(n_now):
            if not arena.kf_valid[c] or c in in_prob:
                continue
            counts = arena.covisibility_counts(c)
            parents = [k for k in np.argsort(-counts) if int(k) in in_prob and counts[k] > 0]
            if not parents:
                continue  # disconnected newborn: leave untouched
            parent = int(parents[0])
            T_rel = arena.kf_pose[c].astype(np.float64) @ np.linalg.inv(
                arena.kf_pose[parent].astype(np.float64)
            )
            post[c] = T_rel @ post[parent]

        # 2. points created after dispatch (or outside the problem): correct
        # through their first observing keyframe's current->post transform.
        # (Uses CURRENT poses as 'pre', so run before the pose write-back.)
        post_has = np.zeros(n_now, bool)
        post_pose = np.zeros((n_now, 4, 4), np.float64)
        for c, T in post.items():
            if c < n_now:
                post_has[c] = True
                post_pose[c] = T
        in_prob_pid = np.zeros(arena.num_pts, bool)
        in_prob_pid[pids[pids < arena.num_pts]] = True
        sel = np.nonzero(arena.pt_valid[: arena.num_pts] & ~in_prob_pid)[0]
        k_first = arena.pt_obs_kf[sel, 0]
        ok = (k_first >= 0) & (k_first < n_now) & post_has[np.maximum(k_first, 0)]
        sel, k_first = sel[ok], k_first[ok]
        if len(sel):
            T_pre = arena.kf_pose[k_first].astype(np.float64)   # (n,4,4)
            X = arena.pt_pos[sel].astype(np.float64)
            Xc = np.einsum("nij,nj->ni", T_pre[:, :3, :3], X) + T_pre[:, :3, 3]
            Tp = post_pose[k_first]
            Xw = np.einsum("nji,nj->ni", Tp[:, :3, :3], Xc - Tp[:, :3, 3])
            arena.pt_pos[sel] = Xw.astype(np.float32)

        # 3. problem points adopt GBA positions
        alive = arena.pt_valid[pids]
        arena.pt_pos[pids[alive]] = new_pt[: len(pids)][alive]

        # 4. keyframe poses
        for c, T in post.items():
            arena.kf_pose[c] = T.astype(np.float32)
        gba = {"cams": len(cams), "points": len(pids), "chi2": float(total_chi2),
               "merged_kfs": len(post) - len(in_prob), "devices": n_shards}
        if "shard_devices" in pending:
            gba["shard_devices"] = pending["shard_devices"]
        self.last_report.update({"gba": gba})
        self.gba_log.append({"kf": pending["kf"], "outcome": "merged"})
        if "partition" in pending:
            self._migrate_after_gba(pending)
        return True

    def _migrate_after_gba(self, pending) -> None:
        """Point-ownership migration after the merge: loop fusion moved
        observations across covisibility segments, so ownership is recomputed
        from the merged map and the rows of the moved points (id, position) are
        re-dealt across the mesh with ONE all_to_all (map_shard.migrate_points),
        where the global BA's merge lands, never on the per-frame path. The
        report says whether every row landed on the rank that now owns it."""
        arena, mesh = self.arena, self.mesh
        n = pending["n_shards"]
        old = pending["partition"]
        new_part = map_shard.partition_arena(arena, n)
        pids = np.nonzero(arena.pt_valid[: arena.num_pts])[0]
        report = {"points": int(len(pids)), "moved": 0, "migrated_ok": True}
        if len(pids):
            old_tab = old.owner_of_pt
            in_old = pids < len(old_tab)
            old_owner = np.where(in_old, old_tab[np.minimum(pids, len(old_tab) - 1)], -1)
            new_owner = (new_part.owner_of_pt[pids] % n).astype(np.int32)
            # rows live on their old owner's rank; points born after the old
            # partition start on their new owner (nothing to move)
            cur_owner = np.where(old_owner >= 0, old_owner % n, new_owner)
            moved = cur_owner != new_owner
            report["moved"] = int(moved.sum())
            if moved.any():
                # re-deal only the MOVED (pid, x, y, z) rows; the capacity covers
                # the worst of the source and destination ranks' loads
                mv = np.nonzero(moved)[0]
                src, dst = cur_owner[mv], new_owner[mv]
                load = np.maximum(np.bincount(src, minlength=n), np.bincount(dst, minlength=n))
                R = global_ba._next_pow2(int(load.max()))
                rows = np.zeros((n * R, 4), np.float32)
                mask = np.zeros(n * R, bool)
                dest = np.zeros(n * R, np.int32)
                order = np.argsort(src, kind="stable")
                so = src[order]
                local = np.arange(len(mv)) - np.searchsorted(so, so)
                gidx = so * R + local
                rows[gidx, 0] = pids[mv][order].astype(np.float32)
                rows[gidx, 1:4] = arena.pt_pos[pids[mv][order]]
                mask[gidx] = True
                dest[gidx] = dst[order]
                rows2, mask2 = map_shard.migrate_points(mesh, rows, mask, dest)
                # every live row must have landed on the rank that now owns it
                got = np.nonzero(mask2)[0]
                owner_tab = np.full(arena.num_pts, -1, np.int32)
                owner_tab[pids] = new_owner
                report["migrated_ok"] = bool(
                    (owner_tab[rows2[got, 0].astype(np.int64)] == got // R).all()
                    and mask2.sum() == mask.sum()
                )
        self.partition = new_part
        report.update(new_part.stats())
        self.last_report["migration"] = report

    # ------------------------------------------------------------------ pose graph

    def _optimize_essential_graph(
        self,
        kf: int,
        loop_kf: int,
        pre_pose: np.ndarray,
        corrected: dict,
        pre_covis: dict,
        loop_connections: dict,
    ) -> None:
        arena = self.arena
        cfg = self.cfg
        n_kfs = arena.num_kfs

        # vertex initial values: corrected Sim3 for the group, current poses otherwise
        V = global_ba._next_pow2(max(n_kfs, 2))
        v_R = np.tile(np.eye(3, dtype=np.float32), (V, 1, 1))
        v_t = np.zeros((V, 3), np.float32)
        v_s = np.ones(V, np.float32)
        v_fixed = np.ones(V, bool)
        v_mask = np.zeros(V, bool)
        pre_sim3 = []
        for i in range(n_kfs):
            S = corrected.get(i)
            if S is None:
                S = np_sim3_from_se3(arena.kf_pose[i])
            pre_sim3.append(S)
            v_R[i] = S["R"]
            v_t[i] = S["t"]
            v_s[i] = S["s"]
            valid = bool(arena.kf_valid[i])
            v_mask[i] = valid
            v_fixed[i] = (i == loop_kf) or not valid

        # Edge construction mirrors optimizer.cpp:756-841:
        #   1. NEW cross-loop connections (LoopConnections) — measurements from the
        #      vertex INITIAL Sim3s (corrected group poses vs. untouched loop-side
        #      poses), so these edges are satisfied at init and anchor the group;
        #   2. spanning tree (strongest earlier covisible, PRE-fuse structure) and
        #      covisibility edges >= minFeat — measurements from PRE-correction
        #      poses (NonCorrectedSim3): the preserved odometry;
        #   3. loop edges from previous closures (KeyFrame::GetLoopEdges).
        e_i: List[int] = []
        e_j: List[int] = []
        e_R: List[np.ndarray] = []
        e_t: List[np.ndarray] = []
        e_s: List[float] = []
        e_w: List[float] = []
        seen = set()

        def add_edge(i: int, j: int, S_ji: dict, w: float = 1.0):
            key = (min(i, j), max(i, j))
            if key in seen or i == j:
                return
            seen.add(key)
            e_i.append(i)
            e_j.append(j)
            e_R.append(np.float32(S_ji["R"]))
            e_t.append(np.float32(S_ji["t"]))
            e_s.append(float(S_ji["s"]))
            e_w.append(w)

        def rel_pre(i: int, j: int) -> dict:
            """S_ji from pre-correction poses."""
            T_ji = pre_pose[j].astype(np.float64) @ np.linalg.inv(pre_pose[i].astype(np.float64))
            return np_sim3_from_se3(T_ji.astype(np.float32))

        def rel_init(i: int, j: int) -> dict:
            """S_ji from the vertex initial values (corrected where applicable)."""
            return np_sim3_compose(pre_sim3[j], np_sim3_inverse(pre_sim3[i]))

        # 1. new cross-loop connections (weight gate except the cur<->loop pair)
        min_feat = cfg.loop.essential_graph_min_feat
        for i, partners in loop_connections.items():
            counts_i = arena.covisibility_counts(i)
            for j in partners:
                j = int(j)
                if j >= n_kfs or not arena.kf_valid[j]:
                    continue
                is_main_pair = {i, j} == {kf, loop_kf}
                if not is_main_pair and counts_i[j] < min_feat:
                    continue
                add_edge(i, j, rel_init(i, j))

        # 2. spanning tree + covisibility edges from the pre-fuse structure
        for i in range(1, n_kfs):
            if not arena.kf_valid[i]:
                continue
            counts = pre_covis.get(i)
            if counts is None:
                continue
            earlier = counts[:i]
            if earlier.size and earlier.max() > 0:
                parent = int(np.argmax(earlier))
                add_edge(i, parent, rel_pre(i, parent))
            strong = np.nonzero(counts >= min_feat)[0]
            for j in strong:
                if j < i:
                    add_edge(i, int(j), rel_pre(i, int(j)))

        # 3. previous loop edges (stored with their at-closure relative Sim3)
        for (a, b, S_ab) in self.loop_edges:
            add_edge(a, b, S_ab)

        E = global_ba._next_pow2(max(len(e_i), 2))
        pad = E - len(e_i)
        eye3 = np.eye(3, dtype=np.float32)
        prob = pose_graph.PoseGraphProblem(
            v_R=self._put(v_R),
            v_t=self._put(v_t),
            v_s=self._put(v_s),
            v_fixed=self._put(v_fixed),
            v_mask=self._put(v_mask),
            e_i=self._put(np.asarray(e_i + [0] * pad, np.int32)),
            e_j=self._put(np.asarray(e_j + [0] * pad, np.int32)),
            e_R=self._put(np.stack(e_R + [eye3] * pad)),
            e_t=self._put(np.stack(e_t + [np.zeros(3, np.float32)] * pad)),
            e_s=self._put(np.asarray(e_s + [1.0] * pad, np.float32)),
            e_mask=self._put(np.asarray([True] * len(e_i) + [False] * pad)),
            e_weight=self._put(np.asarray(e_w + [0.0] * pad, np.float32)),
        )
        res = pose_graph.optimize(prob, iters=cfg.loop.essential_graph_iters)
        v_R2, v_t2, v_s2, cost1, cost0 = (t.cpu().numpy() for t in res)  # final cost before initial
        self.last_report["pose_graph"] = {
            "vertices": int(v_mask.sum()), "edges": len(e_i),
            "cost_before": float(cost0), "cost_after": float(cost1),
        }

        # write back poses + correct every point via its reference keyframe
        # (optimizer.cpp:925-958)
        post_sim3 = [np_sim3(v_R2[i], v_t2[i], v_s2[i]) for i in range(n_kfs)]
        n_pts = arena.num_pts
        ref = arena.pt_obs_kf[:n_pts, 0].copy()
        ref = np.where(ref >= 0, ref, arena.pt_first_kf[:n_pts])
        ok = arena.pt_valid[:n_pts] & (ref >= 0) & (ref < n_kfs)
        for r in np.unique(ref[ok]):
            sel = np.nonzero(ok & (ref == r))[0]
            S_old = pre_sim3[int(r)]
            S_new_inv = np_sim3_inverse(post_sim3[int(r)])
            p = arena.pt_pos[sel].astype(np.float64)
            arena.pt_pos[sel] = np_sim3_apply(
                S_new_inv, np_sim3_apply(S_old, p)
            ).astype(np.float32)
        for i in range(n_kfs):
            if arena.kf_valid[i]:
                arena.kf_pose[i] = np_sim3_to_se3(post_sim3[i])
