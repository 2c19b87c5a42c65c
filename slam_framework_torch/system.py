"""SlamSystem façade of the port: stereo, RGB-D and monocular tracking, local
mapping, place recognition, loop closing and relocalization.

Port of slam_framework_tpu/system.py: construction from a config or a config
file (+ vocabulary), the per-frame entry points TrackStereo / TrackRGBD /
TrackMonocular (slam_system.cpp:89-224), the
localization-mode switch (:131-141), the young-map reset, shutdown statistics,
structured metrics, the KITTI trajectory exports (:264-349) and the map
checkpoint (`save_map` / `load_map`, the reference's SaveMap TODO). The tracker
owns the local mapper (pipeline/local_mapper.py); every new keyframe is handed
to the loop closer (pipeline/loop_closer.py) before the mapper processes it,
and a lost frame to the relocalizer (pipeline/relocalization.py) built from
the loop closer.

The vocabulary is `cfg.vocabulary_path` or the shipped asset; when no file
loads, one is trained online from the first keyframes' descriptors, and place
recognition and relocalization start once it exists.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from slam_framework_torch import resolve_device
from slam_framework_torch.bow import vocabulary as bow_vocab
from slam_framework_torch.config import SlamConfig
from slam_framework_torch.io import checkpoint, trajectory
from slam_framework_torch.map.arena import MapArena
from slam_framework_torch.pipeline.loop_closer import LoopCloser
from slam_framework_torch.pipeline.mono_tracker import MonoTracker
from slam_framework_torch.pipeline.relocalization import Relocalizer
from slam_framework_torch.pipeline.tracker import StereoTracker, TrackingState


class SlamSystem:
    """User-facing engine. One instance per camera stream, on one device."""

    VOCAB_TRAIN_AT_KFS = 6       # train the online vocabulary once this many keyframes exist
    RESET_IF_LOST_BELOW_KFS = 5  # tracker.cpp:613-620

    SENSORS = ("stereo", "rgbd", "monocular")  # util/sensor_type.h:4-8

    def __init__(self, cfg: Optional[SlamConfig] = None, config_path: Optional[str] = None,
                 sensor: Optional[str] = None, sync_every: int = 4,
                 device: Optional[torch.device] = None, place_recognition: bool = True):
        """cfg, or config_path: a JSON file of the reference's schema
        (`SlamConfig.from_json`); sensor overrides the config's.

        device: where images, tracking state and the point block live.
        None means the first CUDA device and raises when there is none; the
        CPU is taken only when the caller passes it.

        place_recognition=False runs tracking and mapping alone: no
        vocabulary is loaded or trained, and there is no loop closer."""
        if cfg is None:
            if config_path is None:
                raise ValueError("provide cfg or config_path")
            cfg = SlamConfig.from_json(config_path, sensor=sensor or "stereo")
        if sensor is not None and sensor != cfg.sensor:
            cfg = dataclasses.replace(cfg, sensor=sensor)
        if cfg.sensor not in self.SENSORS:
            raise ValueError(f"sensor {cfg.sensor!r} is none of {self.SENSORS}")
        if cfg.use_viewer:
            # the reference starts a MapPublisher (its system.py:93-103)
            raise ValueError("use_viewer: the map viewer (viz/) is not ported yet")
        self.cfg = cfg
        self.sync_every = sync_every
        self.device = resolve_device(device)
        self.place_recognition = place_recognition
        self.vocab: Optional[bow_vocab.Vocabulary] = None
        if place_recognition:
            try:
                self.vocab = bow_vocab.load(cfg.vocabulary_path or bow_vocab.SHIPPED_VOCABULARY)
            except (OSError, ValueError, KeyError):
                self.vocab = None  # fall back to online training
        self.n_resets = 0
        self._build()

    def _build(self, arena: Optional[MapArena] = None) -> None:
        cfg = self.cfg
        self.arena = arena if arena is not None else MapArena.create(cfg.capacity, cfg.capacity.max_features)
        tracker_cls = MonoTracker if cfg.sensor == "monocular" else StereoTracker
        self.tracker = tracker_cls(cfg, self.arena, sync_every=self.sync_every, device=self.device)
        self.loop_closer: Optional[LoopCloser] = None
        if self.place_recognition:
            if self.vocab is not None:
                self._activate_place_recognition()
            self.tracker.on_new_keyframe = self._on_new_keyframe

    def reset(self) -> None:
        """Tracker::Reset (tracker.cpp:225-246): clear map and state."""
        self.n_resets += 1
        self._build()

    def shutdown(self) -> dict:
        """Drain buffered frames, the mapper's in-flight work, the deferred loop
        detection and a pending global BA; return run statistics (Shutdown
        :226-247)."""
        self._settle()
        mapper = self.tracker.local_mapper
        caps = dict(mapper.cap_clips)
        if self.loop_closer is not None:
            caps.update(self.loop_closer.cap_clips)
        return {
            "frames": len(self.tracker.records),
            "keyframes": self.arena.n_valid_kfs,
            "map_points": self.arena.n_valid_pts,
            "loops_closed": self.loop_closer.n_loops_closed if self.loop_closer else 0,
            "resets": self.n_resets,
            "ba_aborts": mapper.ba_aborts,
            "cap_clips": caps,
            "mapper": dict(mapper.totals),
        }

    def metrics_summary(self) -> dict:
        """Structured run metrics: tracking aggregates, per-stage wall clocks
        and the capacity clips of every stage."""
        caps = dict(self.tracker.local_mapper.cap_clips)
        if self.loop_closer is not None:
            caps.update(self.loop_closer.cap_clips)
        block_clips = [r for r in self.tracker.metrics.records if r.get("event") == "cap_clip"]
        if block_clips:
            caps["local_block_points"] = sum(r.get("dropped", 0) for r in block_clips)
        return {
            "tracking": self.tracker.metrics.summary(),
            "stages": self.tracker.timers.summary(),
            "cap_clips": caps,
        }

    def dump_metrics(self, path: str) -> None:
        """Write the structured event log (one JSON line per frame / keyframe)."""
        self.tracker.metrics.to_jsonl(path)

    def _require(self, sensor: str) -> None:
        if self.cfg.sensor != sensor:
            raise ValueError(f"a {sensor} entry point on a {self.cfg.sensor} system")

    def track_stereo(self, left: np.ndarray, right: np.ndarray, timestamp: float):
        """Per-frame stereo entry from host images. Returns the latest synced
        Tcw (lags up to sync_every frames) or None."""
        self._require("stereo")
        pose = self.tracker.track(left, right, timestamp)
        self._maybe_reset()
        return pose

    def track_stereo_device(self, pair: torch.Tensor, timestamp: float):
        """Stereo entry for a (2, H, W) uint8 pair already on the system's device."""
        self._require("stereo")
        pose = self.tracker.track_device(pair, timestamp)
        self._maybe_reset()
        return pose

    def track_rgbd(self, gray: np.ndarray, depth: np.ndarray, timestamp: float):
        """Per-frame RGB-D entry (TrackRGBD, slam_system.cpp:131-172): a uint8
        gray image and its registered depth map (metres, or raw units divided by
        `camera.depth_map_factor`), from the host."""
        self._require("rgbd")
        pose = self.tracker.track(gray, depth, timestamp)
        self._maybe_reset()
        return pose

    def track_monocular(self, gray: np.ndarray, timestamp: float):
        """Per-frame monocular entry (TrackMonocular, slam_system.cpp:174-224).
        The scale is free: evaluate trajectories Sim3-aligned."""
        self._require("monocular")
        pose = self.tracker.track_image(gray, timestamp)
        self._maybe_reset()
        return pose

    def _maybe_reset(self) -> None:
        # the reference resets on a young-map loss (tracker.cpp:613-620) even
        # with a relocalizer: the reset comes before the next frame's attempt
        if (
            self.tracker.state == TrackingState.LOST
            and self.arena.n_valid_kfs <= self.RESET_IF_LOST_BELOW_KFS
        ):
            self.reset()

    # ------------------------------------------------------------------ modes

    def activate_localization_mode(self) -> None:
        """Tracking only: no new keyframes, the map stays as it is (slam_system.cpp:131-141)."""
        self.tracker.localization_only = True

    def deactivate_localization_mode(self) -> None:
        self.tracker.localization_only = False

    @property
    def tracking_state(self) -> TrackingState:
        return self.tracker.state

    # ------------------------------------------------------------------ stage wiring

    def _activate_place_recognition(self) -> None:
        mapper = self.tracker.local_mapper
        self.loop_closer = LoopCloser(self.cfg, self.arena, self.tracker.K, self.vocab, kf_store=mapper.kf_store)

        def _forget(k: int) -> None:
            self.loop_closer.db.erase(k)
            self.loop_closer.bow_frames.pop(k, None)

        mapper.on_erase_keyframe = _forget
        # rebuilt with the loop closer, so online vocabulary training renews it too
        self.tracker.relocalizer = Relocalizer(self.cfg, self.arena, self.tracker.K, self.loop_closer,
                                               device=self.device)

    def _on_new_keyframe(self, kf: int) -> None:
        # 1. online vocabulary training once the map has enough texture
        if self.vocab is None and self.arena.n_valid_kfs >= self.VOCAB_TRAIN_AT_KFS:
            self._train_vocabulary()
        closer = self.loop_closer
        if closer is None:
            return
        # catch up the BoW database (the backfill after online training); skip
        # the keyframe whose BoW transform is still in flight on the device:
        # the deferred harvest registers it at the next step
        pending = closer._bow_pending
        pending_kf = pending[0] if pending is not None else None
        for k in range(self.arena.num_kfs):
            if k == kf or k == pending_kf:
                continue
            if self.arena.kf_valid[k] and k not in closer.bow_frames:
                bow = closer.compute_bow(k)
                closer.bow_frames[k] = bow
                closer.db.add(k, bow)
        # 2. merge the global BA of a PREVIOUS loop closure (it needs settled
        # poses: the mapper is finalized only when one is in flight), then run
        # loop detection for this keyframe. Detection is appearance-only; the
        # mapper is drained at the moment a consistent candidate forces a Sim3
        # correction (the pre_close hook), not at every keyframe.
        if closer.has_pending_gba():
            self.tracker.local_mapper.finalize()
            pre = self.arena.kf_pose[kf].copy()
            if closer.apply_pending_gba():
                self._apply_world_correction(pre, self.arena.kf_pose[kf])
        pre_box = {}

        def _pre_close():
            self.tracker.local_mapper.finalize()
            pre_box["pose"] = self.arena.kf_pose[kf].copy()

        if closer.process_keyframe(kf, pre_close=_pre_close):
            self._apply_world_correction(pre_box["pose"], self.arena.kf_pose[kf])

    def _train_vocabulary(self) -> None:
        """Online vocabulary: k=10, depth=4 (10k words) with IDF weights
        refitted from the existing keyframes. A vocabulary file takes
        precedence when one is configured or shipped."""
        arena = self.arena
        descs = arena.kf_desc[: arena.num_kfs][arena.kf_feat_valid[: arena.num_kfs]]
        if len(descs) < 500:
            return
        sample = descs[np.random.default_rng(0).permutation(len(descs))[:30000]]
        self.vocab = bow_vocab.train(sample, k=10, depth=4, seed=0)
        word_lists = []
        for k in range(arena.num_kfs):
            if not arena.kf_valid[k]:
                continue
            d = arena.kf_desc[k][arena.kf_feat_valid[k]]
            word_lists.append(bow_vocab.transform_host(self.vocab, d))
        bow_vocab.refit_idf(self.vocab, word_lists)
        self._activate_place_recognition()

    def _apply_world_correction(self, kf_pose_pre: np.ndarray, kf_pose_post: np.ndarray) -> None:
        """After a loop closure or a global-BA merge rewrote the map under the
        tracker, move the device-resident pose into the corrected world:
        T' = T @ (T_pre^-1 T_post)."""
        st = self.tracker._dstate
        if st is None:
            return
        corr = np.linalg.inv(kf_pose_pre.astype(np.float64)) @ kf_pose_post.astype(np.float64)
        pose = (st.pose.cpu().numpy().astype(np.float64) @ corr).astype(np.float32)
        self.tracker._dstate = st._replace(pose=torch.from_numpy(pose).to(st.pose.device))

    def _settle(self) -> None:
        """Drain ALL in-flight work (buffered frames, the mapper's BA /
        triangulation / fusion, the deferred loop detection, the global BA) so
        that exported state is final."""
        self.tracker.flush()
        if self.loop_closer is not None:
            self._finish_loop_stage()
            self.loop_closer.apply_pending_gba()

    def _finish_loop_stage(self) -> bool:
        """Run the deferred (one-keyframe-late) loop detection for the last
        keyframe and apply the world correction if it closes."""
        arena = self.arena
        valid = np.nonzero(arena.kf_valid[: arena.num_kfs])[0]
        if len(valid) == 0:
            return bool(self.loop_closer.flush())
        anchor = int(valid[-1])
        pre_box = {}

        def _pre_close():
            self.tracker.local_mapper.finalize()
            pre_box["pose"] = arena.kf_pose[anchor].copy()

        closed = self.loop_closer.flush(pre_close=_pre_close)
        if closed:
            self._apply_world_correction(pre_box["pose"], arena.kf_pose[anchor])
        return closed

    def frame_poses(self) -> np.ndarray:
        self._settle()
        return self.tracker.trajectory_poses()

    def save_trajectory_kitti(self, path: str) -> None:
        """Per-frame camera trajectory in KITTI format (slam_system.cpp:264-314)."""
        trajectory.save_kitti(path, self.frame_poses())

    def save_keyframe_trajectory(self, path: str) -> None:
        """Keyframe-only trajectory (slam_system.cpp:316-349)."""
        self._settle()
        kfs = np.nonzero(self.arena.kf_valid[: self.arena.num_kfs])[0]
        trajectory.save_kitti(path, self.arena.kf_pose[kfs])

    # ------------------------------------------------------------------ checkpoint

    def save_map(self, path: str) -> None:
        """Persist map + trajectory records + vocabulary (io/checkpoint.py)."""
        self._settle()
        checkpoint.save_map(path, self.arena, self.tracker.records, self.vocab)

    def load_map(self, path: str) -> None:
        """Restore a saved map (written by either package). The tracker resumes
        LOST and relocalizes against the loaded map on the next frames; the
        trajectory keeps the saved frame numbering. The BoW database is
        backfilled, which also puts every keyframe's features on the device
        store."""
        arena, records, vocab = checkpoint.load_map(path)
        if vocab is not None:
            self.vocab = vocab
        self._build(arena=arena)
        tracker = self.tracker
        if records:
            tracker.records = records
            tracker.frame_id = records[-1].frame_id + 1
        valid = np.nonzero(arena.kf_valid[: arena.num_kfs])[0]
        if len(valid):
            tracker.ref_kf = int(valid[-1])
            tracker.last_kf_frame_id = int(arena.kf_frame_id[valid[-1]])
            tracker.state = TrackingState.LOST  # relocalize to resume
        closer = self.loop_closer
        if closer is not None:
            for k in valid:
                bow = closer.compute_bow(int(k))
                closer.bow_frames[int(k)] = bow
                closer.db.add(int(k), bow)
