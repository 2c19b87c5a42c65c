"""Relocalization: BoW candidates -> batched PnP RANSAC -> motion-only BA.

Port of slam_framework_tpu/pipeline/relocalization.py, after
Tracker::Relocalization (src/core/tracker.cpp:826-991): on tracking loss, the
keyframe database gives BoW candidates (keyframe_database.cpp:179-299), the lost
frame's descriptors are matched against each candidate's map points
(SearchByBoW, orb_matcher.cpp:133-262), a batched PnP RANSAC seeds the pose,
motion-only BA refines it, and the pose is accepted at >= 50 inliers
(tracker.cpp:977, scaled with the feature budget). A weak pose is widened by a
guided projection against the candidate's local map (tracker.cpp:930-975).

Candidates are tried best BoW score first; each one's hypotheses are solved at
once. Every program runs on the relocalizer's device; per candidate the host
reads the match flags, `ok` / `n_inliers` of the RANSAC and the optimized pose.
The RANSAC's index sets are drawn on the host from a `torch.Generator` seeded
11, one draw per candidate that reaches the solver (the reference splits
`PRNGKey(11)` per candidate), so the card and the CPU test the same hypotheses.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from slam_framework_torch import resolve_device
from slam_framework_torch.bow import vocabulary as bow_vocab
from slam_framework_torch.bow.database import BowFrame
from slam_framework_torch.config import SlamConfig
from slam_framework_torch.geometry.projection import Intrinsics
from slam_framework_torch.map.arena import MapArena
from slam_framework_torch.matching import hamming, matcher
from slam_framework_torch.optim import pose_opt
from slam_framework_torch.pipeline.loop_closer import _CovisMap
from slam_framework_torch.solvers import pnp
from slam_framework_torch.solvers.sim3solver import sample_index_sets

N_HYPOTHESES = 256  # PnP RANSAC hypotheses per candidate


def _guided_match(R, t, pts_w, pt_desc, pt_mask, f_xy, f_desc, f_valid,
                  *, K: Intrinsics, width: int, height: int, window: float, max_dist: int):
    """SearchByProjection against a candidate's local points with a pose prior
    (orb_matcher.cpp:1455-1582, called from tracker.cpp:944 with window=10,
    ORBdist=100): project the world points through Tcw, gate the frame's
    features by a pixel window, Hamming-match, one point per frame feature."""
    pc = torch.einsum("ni,ji->nj", pts_w, R) + t[None, :]
    z = torch.where(pc[:, 2] > 1e-6, pc[:, 2], torch.full_like(pc[:, 2], 1e-6))
    uv = torch.stack([K.fx * pc[:, 0] / z + K.cx, K.fy * pc[:, 1] / z + K.cy], dim=-1)
    ok = pt_mask & (pc[:, 2] > 0.05)
    ok &= (uv[:, 0] >= 0) & (uv[:, 0] < width) & (uv[:, 1] >= 0) & (uv[:, 1] < height)
    gate = matcher.window_gate(uv, f_xy, torch.full_like(z, window)) & (ok[:, None] & f_valid[None, :])
    res = matcher.gated_match(hamming.hamming_matrix(pt_desc, f_desc), gate, max_dist=max_dist)
    res = matcher.resolve_duplicate_columns(res, f_xy.shape[0])
    return res.idx, res.valid


class RelocResult(NamedTuple):
    pose: np.ndarray        # (4,4) Tcw
    kf: int                 # matched keyframe
    feat_idx: np.ndarray    # frame feature indices with point associations
    point_ids: np.ndarray   # matching arena point ids
    n_inliers: int


class Relocalizer:
    MIN_BOW_MATCHES = 15    # tracker.cpp:905
    MIN_RETRY = 10          # tracker.cpp:940 (nGood > 10 gates the retry)

    @property
    def MIN_ACCEPT(self) -> int:
        """The reference's 50 inliers (tracker.cpp:977), calibrated to 2000
        features, scaled with the budget and floored well above what a wrong
        candidate's pose gathers."""
        return max(25, round(50 * self.cfg.orb.num_features / 2000))

    def __init__(self, cfg: SlamConfig, arena: MapArena, K: Intrinsics, place_rec, device=None):
        """place_rec: the LoopCloser (vocabulary, database, local points).
        device: None means the first CUDA device and raises when there is none;
        the CPU only when the caller passes it."""
        self.cfg = cfg
        self.arena = arena
        self.K = K
        self.place_rec = place_rec
        self.device = resolve_device(device)
        self._gen = torch.Generator().manual_seed(11)
        self._inv_sf2 = (1.0 / cfg.orb.scale_factor ** (2.0 * np.arange(cfg.orb.num_levels))).astype(np.float32)
        self.n_attempts = 0          # try_relocalize calls
        # the last attempt, per candidate tried: its keyframe, the frame rows with
        # a BoW match, and the inliers of the RANSAC, the motion-only BA and the
        # guided retry (None where the step did not run)
        self.last_report: list = []

    def _put(self, a) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:
            a = a.copy()
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(self.device)

    def _index_sets(self, mask: np.ndarray, set_size: int) -> torch.Tensor:
        """One draw of the RANSAC's (H, set_size) index sets."""
        return sample_index_sets(torch.from_numpy(mask), N_HYPOTHESES, self._gen, set_size=set_size)

    @staticmethod
    def _bow_match(desc_f, valid_f, desc_k, mask_k):
        """SearchByBoW(KF, Frame) for relocalization (orb_matcher.cpp:133-262),
        at a softer 0.9 ratio than the reference's 0.75: the RANSAC and the
        guided retry reject the outliers, and more matches keep more hypotheses."""
        gate = valid_f[:, None] & mask_k[None, :]
        res = matcher.gated_match(hamming.hamming_matrix(desc_f, desc_k), gate, max_dist=50,
                                  nn_ratio=0.9, mutual=True)
        return res.idx, res.valid

    def _levels(self, octave: np.ndarray) -> np.ndarray:
        return self._inv_sf2[np.clip(octave, 0, self.cfg.orb.num_levels - 1)]

    def try_relocalize(self, fd_host: dict) -> Optional[RelocResult]:
        """fd_host: numpy feature block of the lost frame
        {xy (N,2), desc (N,8) u32, valid (N,), octave (N,), u_right (N,)}."""
        pr = self.place_rec
        if pr is None or pr.vocab is None:
            return None
        self.n_attempts += 1
        self.last_report = []
        pr.ensure_bow_current()  # the freshest keyframe must be retrievable
        arena = self.arena
        N = fd_host["desc"].shape[0]
        desc_f = self._put(fd_host["desc"])
        valid_f = self._put(fd_host["valid"])
        word, _, weight = bow_vocab.transform(pr._tables, desc_f, valid_f, depth=pr.vocab.depth, k=pr.vocab.k)
        bow = BowFrame(word.cpu().numpy(), weight.cpu().numpy())
        candidates = pr.db.detect_relocalization_candidates(
            bow, covisibility_groups=_CovisMap(arena, self.cfg.mapping.covisibility_edge_min))
        if not candidates:
            return None
        # best BoW score first (the reference round-robins; scores order the tries)
        candidates = sorted(candidates, key=lambda c: -bow.score(pr.db.frames[c]))[:5]

        store = pr.kf_store
        store.ensure(candidates, arena)
        for cand in candidates:
            pid_c = arena.kf_point_idx[cand]
            mask_c = (pid_c >= 0) & arena.kf_feat_valid[cand]
            mask_c &= np.where(pid_c >= 0, arena.pt_valid[np.maximum(pid_c, 0)], False)
            idx_d, valid_d = self._bow_match(desc_f, valid_f, store.descs[cand].to(self.device), self._put(mask_c))
            idx, valid = idx_d.cpu().numpy(), valid_d.cpu().numpy()
            rows = np.nonzero(valid)[0]
            step = {"kf": int(cand), "rows": rows, "ransac": None, "pose_opt": None, "guided": None}
            self.last_report.append(step)
            if len(rows) < self.MIN_BOW_MATCHES:
                continue
            pids = pid_c[idx[rows]]
            n = len(rows)
            pts_w = np.zeros((N, 3), np.float32)
            uv = np.zeros((N, 2), np.float32)
            inv_s2 = np.ones(N, np.float32)
            mask = np.zeros(N, bool)
            pts_w[:n] = arena.pt_pos[pids]
            uv[:n] = fd_host["xy"][rows]
            inv_s2[:n] = self._levels(fd_host["octave"][rows])
            mask[:n] = True
            # stereo rows: back-project through the stereo depth and solve the
            # 3D-3D RANSAC (planar-safe where the 2-D DLT degenerates on
            # corridor geometry); frames without enough depth take the 2-D solver
            ur_rows = fd_host["u_right"][rows]
            disp = uv[:n, 0] - ur_rows
            has_d = (ur_rows > 0) & (disp > 0.1)
            if int(has_d.sum()) >= 10:
                z = np.where(has_d, self.K.bf / np.maximum(disp, 0.1), 0.0)
                pts_c = np.zeros((N, 3), np.float32)
                pts_c[:n, 0] = (uv[:n, 0] - self.K.cx) * z / self.K.fx
                pts_c[:n, 1] = (uv[:n, 1] - self.K.cy) * z / self.K.fy
                pts_c[:n, 2] = z
                mask3 = np.zeros(N, bool)
                mask3[:n] = has_d
                # min_inliers=6: the RANSAC only seeds the pose; the motion-only
                # BA and the accept bar arbitrate
                res = pnp.solve_pnp3d_ransac(
                    self._put(pts_w), self._put(pts_c), self._put(uv), self._put(inv_s2), self._put(mask3),
                    self.K, self._index_sets(mask3, 3), min_inliers=6)
            else:
                res = pnp.solve_pnp_ransac(
                    self._put(pts_w), self._put(uv), self._put(inv_s2), self._put(mask),
                    self.K, self._index_sets(mask, pnp.MIN_SET), min_inliers=10)
            ok, n_ransac = bool(res.ok), int(res.n_inliers)
            step["ransac"] = n_ransac
            if not ok:
                # a weak consensus is still a pose hypothesis: the guided
                # projection widens the match set and the accept bar arbitrates
                if n_ransac >= 3:
                    got = self._guided_retry(cand, res.pose.cpu().numpy(), fd_host, step)
                    if got is not None:
                        return got
                continue

            # motion-only BA over the FULL match set, seeded by the RANSAC pose
            # (it re-classifies inliers every round, optimizer.cpp:365-401)
            ur = np.full(N, -1.0, np.float32)
            ur[:n] = ur_rows
            obs = pose_opt.PoseObs(points_w=self._put(pts_w), uv=self._put(uv), ur=self._put(ur),
                                   inv_sigma2=self._put(inv_s2), mask=self._put(mask))
            opt = pose_opt.optimize_pose(res.pose, obs, self.K)
            pose, inliers, n_inl = opt.pose.cpu().numpy(), opt.inliers.cpu().numpy(), int(opt.num_inliers)
            step["pose_opt"] = n_inl
            if n_inl >= self.MIN_ACCEPT:
                keep = inliers[:n]
                return RelocResult(pose=pose.astype(np.float32), kf=int(cand), feat_idx=rows[keep],
                                   point_ids=pids[keep].astype(np.int32), n_inliers=n_inl)
            # guided retry (tracker.cpp:930-975) from the optimized pose, or from
            # the RANSAC pose when the BA itself was dragged off
            seed = pose if n_inl >= self.MIN_RETRY else res.pose.cpu().numpy()
            got = self._guided_retry(cand, seed.astype(np.float32), fd_host, step)
            if got is not None:
                return got
        return None

    def _guided_retry(self, cand: int, pose: np.ndarray, fd_host: dict,
                      step: Optional[dict] = None) -> Optional[RelocResult]:
        pts_l, desc_l, ids_l = self.place_rec._local_points_of(cand)
        cfg = self.cfg
        idx_d, valid_d = _guided_match(
            self._put(pose[:3, :3]), self._put(pose[:3, 3]),
            self._put(pts_l), self._put(desc_l), self._put(ids_l >= 0),
            self._put(fd_host["xy"]), self._put(fd_host["desc"]), self._put(fd_host["valid"]),
            K=self.K, width=cfg.camera.width, height=cfg.camera.height, window=10.0, max_dist=100,
        )
        idx, valid = idx_d.cpu().numpy(), valid_d.cpu().numpy()
        slots = np.nonzero(valid)[0]          # point slots with a frame match
        if step is not None:
            step["guided"] = 0
        if len(slots) < self.MIN_ACCEPT:
            return None
        feats = idx[slots]                    # matched frame feature per slot
        P = pts_l.shape[0]
        uv = np.zeros((P, 2), np.float32)
        ur = np.full(P, -1.0, np.float32)
        inv_s2 = np.ones(P, np.float32)
        mask = np.zeros(P, bool)
        uv[slots] = fd_host["xy"][feats]
        ur[slots] = fd_host["u_right"][feats]
        inv_s2[slots] = self._levels(fd_host["octave"][feats])
        mask[slots] = True
        obs = pose_opt.PoseObs(points_w=self._put(pts_l), uv=self._put(uv), ur=self._put(ur),
                               inv_sigma2=self._put(inv_s2), mask=self._put(mask))
        opt = pose_opt.optimize_pose(self._put(np.asarray(pose, np.float32)), obs, self.K)
        pose2, inliers, n_inl = opt.pose.cpu().numpy(), opt.inliers.cpu().numpy(), int(opt.num_inliers)
        if step is not None:
            step["guided"] = n_inl
        if n_inl < self.MIN_ACCEPT:
            return None
        keep = np.nonzero(inliers)[0]
        return RelocResult(pose=pose2.astype(np.float32), kf=int(cand), feat_idx=idx[keep],
                           point_ids=ids_l[keep].astype(np.int32), n_inliers=n_inl)
