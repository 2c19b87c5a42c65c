"""Stereo / RGB-D tracking stage: device-resident tracking state + chunked host bookkeeping.

Port of the tracking slice of slam_framework_tpu/pipeline/tracker.py: stereo
initialisation, per-frame motion-model / reference-fallback / local-map
tracking with pose optimisation, the keyframe decision and creation with new
points from stereo depth, the local-block rebuild and the trajectory export.
The sensor picks the front-end (`_make_frontend`): a stereo frame is a (2, H, W)
uint8 pair, an RGB-D frame a (2, H, W) float32 (gray, depth) pair, and
pipeline/mono_tracker.py's monocular frame one (1, H, W) uint8 image; the rest
of the machine is shared, and a frame without depth spawns no depth points.

Frames are processed in chunks of `sync_every`: the front-end and the
tracking core run frame by frame on the device (the reference's `lax.map` +
`lax.scan`), and the host reads the chunk's summaries back once and makes the
keyframe decisions `sync_every` frames behind, as the reference does.

Every keyframe goes through the local mapper (pipeline/local_mapper.py: point
culling, multi-view triangulation, neighbour fusion, keyframe culling, local
BA), and `flush()` finalizes it. Just before that, `on_new_keyframe` (set by
SlamSystem) hands the keyframe to place recognition and loop closing.

A lost frame goes to the relocalizer (pipeline/relocalization.py, set by
SlamSystem once place recognition exists): the front-end runs on the device,
the feature block is read back once, and on success the device state is
re-seeded from the relocalized pose and chunked tracking resumes, under the
stricter inlier bar for `max_frames_between_kfs` frames. In localization mode
(`localization_only`) no keyframe is made; the reference keyframe then follows
the camera and the block is rebuilt around it, which the reference package
omits (its block refreshes at keyframes only, so it goes stale).

Chunks are dispatched and fetched in the reference's pipeline order
(`pipeline_depth`, 2 by default, as in the reference). `_dispatch` launches
the chunk's front-end and tracking core frame by frame and queues its device
tensors in `_pending`; `_fetch` reads the oldest one back, together with the
mapper's in-flight results (launched at the previous chunk's keyframes), and
`_process` makes the host bookkeeping. At depth 1 a chunk is fetched and
processed right after its dispatch. At depth 2, once the map has
`MATURE_MAP_KFS` keyframes, a chunk stays in flight while the next one
buffers, and at each full buffer the order is fetch -> process-critical ->
dispatch -> deferred: the critical part lands the mapper's results at a
keyframe (fuse, then triangulation, then BA), culls points, inserts the
keyframe and rebuilds the block, whose remap precedes the next dispatch; the
heavy mapper stage (triangulation and local-BA launches, keyframe culling)
and the write-backs of a chunk without a keyframe are queued in `_deferred`
and run after the next chunk is launched, so the host works on them while the
card finishes that chunk (where a chunk made two keyframes, the second one's
stage first lands the first one's BA: pipeline/local_mapper.py). On a loss every pending and buffered frame is
recorded lost and dropped: at depth 2 that is the chunk buffered behind the
lost one. The monocular mapper stays synchronous at either depth.

A dispatched frame runs as stages (`_run_frame`): the front-end's two, with
its one FAST+NMS launch between them, then motion, the fallback where the
motion path keeps fewer than FALLBACK_BELOW inliers, and the local map. On the
card each stage is a CUDA graph captured on first use and replayed after
(pipeline/stage_graphs.py), over tensors held at fixed addresses: the staged
frame is copied in, the device state (`_dstate`) and the block (`_block`)
are held and assigned by copying in, and the local stage writes the next state
in place. Initialization and relocalization run eagerly.

Not carried: the reference's `lax.cond` around the fallback ladder is a host
branch here, one read of the motion path's inliers per frame between the
motion and local stages, so a dispatch waits for each frame's motion tracking; and the
reference's packing of a fetch into one buffer (`_pack_payload`, the zero
placeholders `_ph`, `aux_fetch`), which served a remote device behind a
per-call latency.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import numpy as np
import torch

from slam_framework_torch import resolve_device
from slam_framework_torch.config import SlamConfig
from slam_framework_torch.geometry import se3
from slam_framework_torch.map.arena import MapArena
from slam_framework_torch.ops import fast_cuda
from slam_framework_torch.pipeline import track_ops
from slam_framework_torch.pipeline.frame import FrameData, Frontend, RgbdFrontend, StereoFrontend
from slam_framework_torch.pipeline.local_mapper import LocalMapper
from slam_framework_torch.pipeline.stage_graphs import Ran, StageGraphs, copy_into, hold
from slam_framework_torch.utils.observability import MetricsLog, StageTimers, trace_span


class TrackingState(enum.Enum):
    """Mirrors src/util/tracking_state.h."""

    SYSTEM_NOT_READY = 0
    NO_IMAGES_YET = 1
    NOT_INITIALIZED = 2
    OK = 3
    LOST = 4


class DeviceTrackState(NamedTuple):
    """Per-frame tracking state that stays on the device across frames."""

    pose: torch.Tensor        # (4,4) Tcw of last tracked frame
    velocity: torch.Tensor    # (4,4) T_cur_last motion model
    desc: torch.Tensor        # (N,8) last frame descriptors (int32 bits)
    octave: torch.Tensor      # (N,) int32
    angle: torch.Tensor       # (N,) f32
    pt_pos: torch.Tensor      # (N,3) world position of the point tracked by each feature
    pt_mask: torch.Tensor     # (N,) bool — feature has a map point
    assoc_slot: torch.Tensor  # (N,) int32 — local-block slot per feature (-1 none)


class MotionResult(NamedTuple):
    """What the local-map stage starts from: the motion path's result, or the
    fallback's where that locked on better."""

    pose: torch.Tensor       # (4,4) Tcw
    prior: torch.Tensor      # (N,) int32 — local-block slot per feature (-1 none)
    n_inliers: torch.Tensor  # () int32 — the motion path's inliers


# the reference-keyframe fallback runs when the motion path keeps fewer inliers
FALLBACK_BELOW = 60


# summary layout (f32): [0:16]=pose, [16]=n_matches, [17]=n_inliers,
# [18]=n_close_tracked, [19]=n_close_untracked, [20]=n_valid_feats,
# [21]=n_visible, [22]=motion inliers
SUMMARY_LEN = 24


class FrameRecord:
    __slots__ = ["frame_id", "timestamp", "pose", "lost", "ref_kf", "rel_pose"]

    def __init__(self, frame_id, timestamp, pose, lost, ref_kf, rel_pose=None):
        self.frame_id = frame_id
        self.timestamp = timestamp
        self.pose = pose
        self.lost = lost
        self.ref_kf = ref_kf
        self.rel_pose = rel_pose  # Tcr = Tcw @ Trw^-1 at record time (tracker.cpp:629-642)


class StereoTracker:
    MAX_KFS_PER_CHUNK = 1  # keyframe budget per chunk, scaled with sync_every
    MATURE_MAP_KFS = 12    # depth 2 waits for this many keyframes
    frontend_images = 2    # images per staged frame: (left, right) or (gray, depth)

    def __init__(self, cfg: SlamConfig, arena: Optional[MapArena] = None, sync_every: int = 4,
                 pipeline_depth: int = 2, device: Optional[torch.device] = None):
        """pipeline_depth: chunks in flight before one is fetched; 2 keeps a
        chunk on the device while the next one buffers (see the module
        docstring), 1 fetches each chunk right after its dispatch."""
        self.cfg = cfg
        # None: the first CUDA device, or an error when there is none
        self.device = resolve_device(device)
        self.frontend = self._make_frontend()
        self.K = self.frontend.K
        self.arena = arena or MapArena.create(cfg.capacity, cfg.capacity.max_features)
        self.state = TrackingState.NO_IMAGES_YET
        self.sync_every = max(1, sync_every)
        self.pipeline_depth = max(1, pipeline_depth)
        # the keyframe cadence is set in frames, not chunks (tracker.cpp:1224-1306)
        self.max_kfs_per_chunk = max(self.MAX_KFS_PER_CHUNK, round(self.sync_every / 4))
        self.ref_kf = -1
        self.ref_kf_tracked = 0
        self.last_kf_frame_id = -1
        self.frame_id = 0
        self.records: list[FrameRecord] = []
        self.metrics = MetricsLog()
        self.timers = StageTimers()
        self.on_new_keyframe = None  # hook: called with the keyframe's id after insertion
        self.local_mapper = LocalMapper(cfg, self.arena, self.K, timers=self.timers, device=self.device)
        self.relocalizer = None            # set by SlamSystem once place recognition exists
        self.localization_only = False     # ActivateLocalizationMode (slam_system.h:38)
        self._last_reloc_fid = -(10**9)    # start of the strict inlier bar (tracker.cpp:1166)
        # the device state and the block, held where the captured stages read them
        self._state_held: Optional[DeviceTrackState] = None
        self._block_held: Optional[track_ops.PointBlock] = None
        self._stage_graphs = StageGraphs(self.device)
        self.frontend_frames = 0   # frames through a front-end: dispatched, initialization, relocalization
        self.replayed_frames = 0   # dispatched frames whose every stage ran as a graph replay
        self.graph_captures = 0    # stage graphs captured
        self.fallback_replays = 0  # fallback stages that ran as a graph replay
        self._block_ids: Optional[np.ndarray] = None   # (P,) int32 — point id per block slot
        self._block_pos_host: Optional[np.ndarray] = None
        self._buf = []                 # buffered (frame, frame_id, timestamp) awaiting a chunk
        self._pending = []             # dispatched chunks awaiting a fetch (see _dispatch)
        self._pending_remap = None     # pre-rebuild block ids awaiting the device-state remap
        self._deferred = []            # [(kind, fn)] host work run after the next dispatch

    @property
    def _dstate(self) -> Optional[DeviceTrackState]:
        """The device tracking state. Assigning one copies it into the tensors
        held here (made on the first assignment), which the stages read and
        the local stage rewrites in place."""
        return self._state_held

    @_dstate.setter
    def _dstate(self, state: DeviceTrackState) -> None:
        self._state_held = hold(self._state_held, state)

    @property
    def _block(self) -> Optional[track_ops.PointBlock]:
        """The local point block, held like `_dstate`: a rebuild copies in."""
        return self._block_held

    @_block.setter
    def _block(self, block: track_ops.PointBlock) -> None:
        self._block_held = hold(self._block_held, block)

    def _make_frontend(self):
        if self.cfg.sensor == "rgbd":
            return RgbdFrontend(self.cfg)
        return StereoFrontend(self.cfg)

    def _current_sync(self) -> int:
        """Frames per chunk; the monocular tracker shortens it while the map is young."""
        return self.sync_every

    def _current_depth(self) -> int:
        """Pipeline depth: 1 while the map is young (a bootstrap-age map loses
        tracking under depth 2), `pipeline_depth` once it has MATURE_MAP_KFS
        keyframes."""
        if self.arena.n_valid_kfs < self.MATURE_MAP_KFS:
            return 1
        return self.pipeline_depth

    # ------------------------------------------------------------------ device program

    def _track_core(self, state: DeviceTrackState, fd: FrameData, block: track_ops.PointBlock):
        """One tracked frame: motion model, fallback ladder, local map, velocity,
        summary, fusion candidates and the per-slot visible/found counts. The
        composition of the stages that `_run_frame` replays."""
        motion = self._motion_stage(state, fd)
        # TrackReferenceKeyFrame ladder (tracker.cpp:486-540) when the motion
        # lock is weak. The reference's lax.cond is a host branch here: one
        # device->host read per frame.
        if int(motion.n_inliers) < FALLBACK_BELOW:
            motion = self._fallback_stage(state, fd, block, motion)
        return self._local_stage(state, fd, block, motion)

    def _motion_stage(self, state: DeviceTrackState, fd: FrameData) -> MotionResult:
        """TrackWithMotionModel: the velocity's prediction, the search against
        the last frame and the pose optimisation."""
        cfg = self.cfg
        pred = se3.compose(state.velocity, state.pose)
        res1 = track_ops.track_motion(
            fd, pred, state.pt_pos, state.desc, state.octave, state.angle,
            state.pt_mask, K=self.K,
            num_levels=cfg.orb.num_levels, scale_factor=cfg.orb.scale_factor,
        )
        ok1 = (res1.assoc >= 0) & res1.inlier
        minus1 = torch.full_like(res1.assoc, -1)
        prior = torch.where(ok1, state.assoc_slot[torch.clamp(res1.assoc, min=0).long()], minus1)
        return MotionResult(pose=res1.pose, prior=prior, n_inliers=res1.n_inliers)

    def _fallback_stage(self, state: DeviceTrackState, fd: FrameData, block: track_ops.PointBlock,
                        motion: MotionResult) -> MotionResult:
        """The reference-keyframe fallback, adopted only where it locked on
        better than the motion path."""
        fb = track_ops.track_reference_fallback(fd, state.pose, block, K=self.K)
        prior_fb = torch.where((fb.assoc >= 0) & fb.inlier, fb.assoc, torch.full_like(fb.assoc, -1))
        good = (fb.n_inliers >= 10) & (fb.n_inliers > motion.n_inliers)
        return motion._replace(pose=torch.where(good, fb.pose, motion.pose),
                               prior=torch.where(good, prior_fb, motion.prior))

    def _local_stage(self, state: DeviceTrackState, fd: FrameData, block: track_ops.PointBlock,
                     motion: MotionResult):
        """TrackLocalMap from the motion path's (or the fallback's) pose, then
        the new state, the summary, the fusion candidates, the feature pack and
        the per-slot visible/found counts."""
        cfg = self.cfg
        minus1 = torch.full_like(motion.prior, -1)
        # th=2: the block refreshes one chunk late, so the wider window recovers
        # the associations a fresh map would give with th=1
        wh = (cfg.camera.width, cfg.camera.height)
        res2 = track_ops.track_local_map(
            fd, motion.pose, motion.prior, block, K=self.K, th=2.0,
            num_levels=cfg.orb.num_levels, scale_factor=cfg.orb.scale_factor, image_wh=wh,
        )
        ok2 = (res2.assoc >= 0) & res2.inlier
        slot = torch.where(ok2, res2.assoc, minus1)

        vel_full = se3.compose(res2.pose, se3.se3_inverse(state.pose))
        # IIR-smoothed rotation rate (config.py velocity_rotation_smoothing)
        a = cfg.tracker.velocity_rotation_smoothing
        w_meas = se3.so3_log(vel_full[:3, :3])
        w_prev = se3.so3_log(state.velocity[:3, :3])
        velocity = se3.rt_to_mat(se3.so3_exp((1.0 - a) * w_meas + a * w_prev), vel_full[:3, 3])
        new_state = DeviceTrackState(
            pose=res2.pose,
            velocity=velocity,
            desc=fd.desc,
            octave=fd.octave,
            angle=fd.angle,
            pt_pos=block.pos[torch.clamp(slot, min=0).long()],
            pt_mask=slot >= 0,
            assoc_slot=slot,
        )

        close = (fd.depth > 0) & (fd.depth < cfg.depth_threshold) & fd.valid
        f32 = torch.float32
        summary = torch.cat([
            res2.pose.reshape(-1),
            torch.stack([
                res2.n_matches.to(f32), res2.n_inliers.to(f32),
                (close & (slot >= 0)).sum().to(f32), (close & (slot < 0)).sum().to(f32),
                fd.valid.sum().to(f32), res2.visible.sum().to(f32), motion.n_inliers.to(f32),
            ]),
            torch.zeros(SUMMARY_LEN - 23, dtype=f32, device=slot.device),
        ])

        # duplicate suppression for keyframe creation (OrbMatcher::Fuse semantics)
        fuse = track_ops.fuse_candidates(
            fd, res2.pose, slot, block, K=self.K,
            num_levels=cfg.orb.num_levels, scale_factor=cfg.orb.scale_factor, image_wh=wh,
        )
        pack = torch.stack(
            [fd.xy[:, 0], fd.xy[:, 1], fd.u_right, fd.depth, fd.octave.to(f32), fd.angle,
             fd.valid.to(f32), slot.to(f32), fuse.to(f32)],
            dim=-1,
        )
        P = block.pos.shape[0]
        vis = res2.visible.to(torch.int32)
        # unmatched features add into a spare row P that is dropped
        found_idx = torch.where(ok2, slot, torch.full_like(slot, P)).long()
        found = torch.zeros(P + 1, dtype=torch.int32, device=slot.device)
        found.index_add_(0, found_idx, torch.ones_like(slot))
        return new_state, summary, pack, fd.desc, vis, found[:P]

    def _staged(self) -> bool:
        """Whether frames run as the stages that `_track_core` and the
        front-end's call are made of. Where either is replaced, on the instance
        or on its class (slambench/faults.py plants its faults so, and
        tools/replay_blackout.py records stages so), the replacement runs
        instead, eagerly."""
        return (getattr(self._track_core, "__func__", None) is StereoTracker._track_core
                and type(self.frontend).__call__ is Frontend.__call__)

    def _run_frame(self, frame: torch.Tensor, block: track_ops.PointBlock):
        """One frame through the stages of the front-end and of `_track_core`,
        each a CUDA graph on the card (pipeline/stage_graphs.py), captured per
        frame shape and dtype and block capacity and replayed after: the frame
        is copied in, the FAST+NMS launch runs between the front-end's two
        stages, the motion path's inliers are read once, the fallback stage runs
        only under FALLBACK_BELOW of them, and the local stage writes the next
        device state in place as its last step. Returns the frame's summary,
        pack and descriptors as fresh tensors, and its visible / found counts
        held until the next frame."""
        g = self._stage_graphs
        key = (tuple(frame.shape), frame.dtype)
        ckey = key + (block.pos.shape[0],)
        fe = self.frontend
        with trace_span("tracker/frontend"):
            images = g.keep(("frame", key), (frame,))[0]
            ran = [g.run(("levels", key), lambda: g.keep(("levels", key), fe.levels(*images)))]
            levels = g.held[("levels", key)]
            maps = g.keep(("maps", key), fast_cuda.fast_nms_strength_levels(levels[: fe.n_fast]))
            ran.append(g.run(("features", key),
                             lambda: g.keep(("features", key), fe.features(images, levels, maps))))
            fd = g.held[("features", key)]
        with trace_span("tracker/track_core"):
            state = self._dstate
            ran.append(g.run(("motion", ckey), lambda: g.keep(("motion", ckey), self._motion_stage(state, fd))))
            motion = g.held[("motion", ckey)]
            if int(motion.n_inliers) < FALLBACK_BELOW:
                ran.append(g.run(("fallback", ckey),
                                 lambda: copy_into(motion, self._fallback_stage(state, fd, block, motion))))
                self.fallback_replays += ran[-1] is Ran.REPLAY

            def local() -> None:
                new_state, *out = self._local_stage(state, fd, block, motion)
                g.keep(("local", ckey), out)
                copy_into(state, new_state)  # after every read of the old state

            ran.append(g.run(("local", ckey), local))
            summary, pack, desc, vis, found = g.held[("local", ckey)]
        self.replayed_frames += all(r is Ran.REPLAY for r in ran)
        self.graph_captures += sum(r is Ran.CAPTURE for r in ran)
        return summary.clone(), pack.clone(), desc.clone(), vis, found

    def _run_frame_eagerly(self, frame: torch.Tensor, block: track_ops.PointBlock):
        """One frame through the front-end's call and `_track_core` as they
        are, for `_staged() == False`; returns what `_run_frame` returns."""
        with trace_span("tracker/frontend"):
            fd = self.frontend(*frame)
        with trace_span("tracker/track_core"):
            state, summary, pack, desc, vis, found = self._track_core(self._dstate, fd, block)
        self._dstate = state
        return summary, pack, desc, vis, found

    def _dispatch(self) -> None:
        """Launch the front-end and the tracking core for every buffered frame
        against one block, and queue the chunk's device tensors in `_pending`.
        Nothing here waits for the chunk's results, except the per-frame read
        of the motion path's inliers."""
        if self._pending_remap is not None:
            with self.timers.time("dispatch/remap"):
                self._remap_device_state(self._pending_remap)
            self._pending_remap = None
        batch, self._buf = self._buf, []
        block = self._block
        P = block.pos.shape[0]
        vis = torch.zeros(P, dtype=torch.int32, device=self.device)
        found = torch.zeros_like(vis)
        summaries, packs, descs = [], [], []
        run = self._run_frame if self._staged() else self._run_frame_eagerly
        for frame, _fid, _ts in batch:
            summary, pack, desc, v, f = run(frame, block)
            self.frontend_frames += 1
            summaries.append(summary)
            packs.append(pack)
            descs.append(desc)
            vis += v
            found += f
        self._pending.append((
            [b[1] for b in batch], [b[2] for b in batch],
            torch.stack(summaries), torch.stack(packs), torch.stack(descs), vis, found, self._block_ids,
        ))

    def _fetch(self):
        """Read the oldest pending chunk back to the host, together with the
        mapper's in-flight results (launched at the previous chunk's keyframes;
        None where nothing is in flight), in the form `_process` takes."""
        # the mapper launches queued by `_process(defer=True)` must exist before
        # their results are read: `track_device` runs the queue right after the
        # next dispatch, and depth 1 and `flush` queue nothing
        assert not self._deferred, "fetch with deferred host work still queued"
        fids, tss, summaries, packs, descs, vis, found, block_ids = self._pending.pop(0)
        mapper = self.local_mapper
        ba_data, tri_data, fuse_data = (
            None if h is None else [t.cpu().numpy() for t in h]
            for h in (mapper.ba_handles(), mapper.tri_handles(), mapper.fuse_handles())
        )
        return (
            fids, tss, summaries.cpu().numpy(), vis.cpu().numpy(), found.cpu().numpy(), packs.cpu().numpy(),
            descs.cpu().numpy().view(np.uint32), block_ids, ba_data, tri_data, fuse_data, packs, descs,
        )

    def _drain(self) -> None:
        """Fetch and process the oldest pending chunk (the serial path)."""
        with self.timers.time("drain"), trace_span("tracker/fetch"):
            raw = self._fetch()
        with self.timers.time("process"), trace_span("tracker/process"):
            self._process(raw)

    def _run_deferred(self) -> None:
        """Run the queued host work of `_process(defer=True)`: the heavy stage
        of each keyframe in order, or the write-backs of a chunk without one."""
        q, self._deferred = self._deferred, []
        for _kind, fn in q:
            fn()

    # ------------------------------------------------------------------ main entry

    def _to_pair(self, left: np.ndarray, right: np.ndarray) -> torch.Tensor:
        """Host images -> one staged frame on the device; gray (uint8) and depth
        (float) share float32 in an RGB-D frame."""
        dtype = np.float32 if self.cfg.sensor == "rgbd" else None
        return torch.from_numpy(np.stack([np.asarray(left, dtype), np.asarray(right, dtype)])).to(self.device)

    def track(self, left: np.ndarray, right: np.ndarray, timestamp: float) -> Optional[np.ndarray]:
        """Feed one stereo pair, or (gray, depth) in RGB-D mode, from HOST arrays.
        Returns the latest synced pose (lags up to sync_every frames) or None.
        Call flush() to drain at end."""
        return self.track_device(self._to_pair(left, right), timestamp)

    def track_device(self, frame: torch.Tensor, timestamp: float) -> Optional[np.ndarray]:
        """Feed one frame already on the tracker's device: a (2, H, W) uint8
        stereo pair, for RGB-D a (2, H, W) float32 (gray, depth) pair, for the
        MonoTracker one (1, H, W) uint8 image."""
        if (frame.dim() != 3 or frame.shape[0] != self.frontend_images
                or (self.cfg.sensor == "rgbd" and frame.dtype != torch.float32)):
            raise ValueError(f"a {self.cfg.sensor} frame is {self.frontend_images} images of (H, W)"
                             + (" in float32" if self.cfg.sensor == "rgbd" else "")
                             + f", not {tuple(frame.shape)} {frame.dtype}")
        if self.state in (TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED):
            self.frontend_frames += 1
            ok = self._initialize(frame, timestamp)
            self.state = TrackingState.OK if ok else TrackingState.NOT_INITIALIZED
            self.frame_id += 1
            return self.records[-1].pose if ok else None
        if self.state == TrackingState.LOST:
            self.frontend_frames += 1
            with self.timers.time("relocalize"), trace_span("tracker/relocalize"):
                self._track_lost(frame, timestamp)
            self.frame_id += 1
            return self.records[-1].pose
        self._buf.append((frame, self.frame_id, timestamp))
        self.frame_id += 1
        if len(self._buf) >= self._current_sync():
            if self._current_depth() > 1 and not self._pending:
                # prime the pipeline: this chunk runs while the next one buffers
                with self.timers.time("dispatch"), trace_span("tracker/dispatch"):
                    self._dispatch()
            elif self._current_depth() > 1:
                # fetch -> process-critical -> dispatch -> deferred: the
                # keyframe's insertion, block rebuild and remap precede the next
                # chunk; the heavy mapper stage runs while that chunk computes
                with self.timers.time("drain"), trace_span("tracker/fetch"):
                    raw = self._fetch()
                with self.timers.time("process"), trace_span("tracker/process"):
                    self._process(raw, defer=True)
                if self._buf:  # a loss drops the buffered chunk
                    with self.timers.time("dispatch"), trace_span("tracker/dispatch"):
                        self._dispatch()
                with self.timers.time("process/deferred"), trace_span("tracker/deferred"):
                    self._run_deferred()
            else:
                with self.timers.time("dispatch"), trace_span("tracker/dispatch"):
                    self._dispatch()
                while self._pending:
                    self._drain()
        return self.records[-1].pose if self.records else None

    def flush(self) -> None:
        """Process all buffered and pending frames. Tail frames run one chunk
        each, as the reference dispatches them through its fixed (1, ...) chunk
        shape; each is dispatched before the chunks still pending are drained."""
        rest, self._buf = self._buf, []
        for item in rest:
            if self.state == TrackingState.LOST:
                self.records.append(FrameRecord(item[1], item[2], None, True, self.ref_kf))
                continue
            self._buf = [item]
            with self.timers.time("dispatch"), trace_span("tracker/dispatch"):
                self._dispatch()
            while self._pending:
                self._drain()
        while self._pending:
            self._drain()
        self.local_mapper.finalize()

    # ------------------------------------------------------------------ host sync

    def _process(self, raw, defer: bool = False) -> None:
        """Host bookkeeping for one chunk: records, lost detection, keyframe
        decision/creation, visible/found accrual, mapper result landing.

        defer=True (depth 2) queues the heavy stage of each keyframe and the
        write-backs of a chunk without one in `_deferred`; the caller runs them
        after dispatching the next chunk. What that chunk depends on (the
        write-backs at a keyframe, its insertion, the block rebuild and the
        remap) happens here."""
        (fids, tss, summaries, vis, found, packs, descs, block_ids,
         ba_data, tri_data, fuse_data, packs_dev, descs_dev) = raw
        # per-frame visible/found accrual against the block the chunk ran with
        live = block_ids >= 0
        pids = block_ids[live]
        ok_pid = self.arena.pt_valid[pids]
        self.arena.pt_n_visible[pids[ok_pid]] += vis[live][ok_pid]
        self.arena.pt_n_found[pids[ok_pid]] += found[live][ok_pid]
        made_kf = 0
        last_tracked = None
        for j, (fid, ts) in enumerate(zip(fids, tss)):
            if self.state == TrackingState.LOST:
                # frames after a lost frame were tracked from a lost state
                self.records.append(FrameRecord(fid, ts, None, True, self.ref_kf))
                continue
            s = summaries[j]
            pose = s[0:16].reshape(4, 4).astype(np.float32)
            n_inliers = int(s[17])
            # TrackLocalMap acceptance (tracker.cpp:1166-1174): 30 inliers, 50
            # within max_frames_between_kfs of a relocalization, both scaled
            # with the feature budget (exact at 2000 features)
            nf_scale = self.cfg.orb.num_features / 2000.0
            min_inl = max(15, round(self.cfg.tracker.track_local_map_min_inliers * nf_scale))
            if fid - self._last_reloc_fid < self.cfg.max_frames_between_kfs:
                min_inl = max(min_inl, round(self.cfg.tracker.track_local_map_min_inliers_reloc * nf_scale))
            if n_inliers < min_inl:
                self.state = TrackingState.LOST
                rec = FrameRecord(fid, ts, None, True, self.ref_kf)
                self.metrics.add(event="frame", frame_id=fid, lost=True,
                                 matches=int(s[16]), inliers=n_inliers)
            else:
                self.state = TrackingState.OK
                last_tracked = j
                rec = FrameRecord(fid, ts, pose, False, self.ref_kf)
                self.metrics.add(event="frame", frame_id=fid,
                                 matches=int(s[16]), inliers=n_inliers,
                                 visible=int(s[21]), motion_inliers=int(s[22]),
                                 close_tracked=int(s[18]), close_new=int(s[19]))
                if (made_kf < self.max_kfs_per_chunk and not self.localization_only
                        and self._need_new_keyframe(fid, s)):
                    self._create_keyframe(
                        fid, ts, pose, packs[j], descs[j], block_ids, packs_dev[j], descs_dev[j],
                        ba_data=ba_data, tri_data=tri_data, fuse_data=fuse_data, defer=defer,
                    )
                    ba_data = tri_data = fuse_data = None  # consumed
                    rec.ref_kf = self.ref_kf
                    made_kf += 1
                rec.rel_pose = self._rel_to_ref(pose, rec.ref_kf)
            self.records.append(rec)
        if fuse_data is not None or tri_data is not None or ba_data is not None:
            # no keyframe this chunk: still land the fetched fuse / triangulation /
            # local-BA results (a settled result never sits stale across chunks).
            # Nothing rebuilds the block before the next keyframe, so at depth 2
            # they land after the next dispatch.
            def land(fuse_data=fuse_data, tri_data=tri_data, ba_data=ba_data) -> None:
                if fuse_data is not None:
                    self.local_mapper.apply_pending_fuse(prefetched=fuse_data)
                if tri_data is not None:
                    self.local_mapper.apply_pending_triangulation(prefetched=tri_data)
                if ba_data is not None:
                    self.local_mapper.flush_ba(prefetched=ba_data)

            if defer:
                self._deferred.append(("writeback", land))
            else:
                land()
        if self.localization_only and self.state == TrackingState.OK and last_tracked is not None:
            self._follow_reference_keyframe(packs[last_tracked], block_ids)
        if self.state == TrackingState.LOST:
            # drop pending and buffered work: it descends from the lost state
            for fids2, tss2, *_ in self._pending:
                for fid2, ts2 in zip(fids2, tss2):
                    self.records.append(FrameRecord(fid2, ts2, None, True, self.ref_kf))
            self._pending = []
            for (_frame, fid2, ts2) in self._buf:
                self.records.append(FrameRecord(fid2, ts2, None, True, self.ref_kf))
            self._buf = []

    def _follow_reference_keyframe(self, pack: np.ndarray, block_ids: np.ndarray) -> None:
        """Localization mode makes no keyframe, so nothing would rebuild the local
        block as the camera moves on. The reference keyframe follows the camera
        instead: the keyframe observing the most of the frame's tracked points
        (UpdateLocalKeyFrames, tracker.cpp:1047-1117; the lowest id on a tie),
        and the block is rebuilt around it when it changes."""
        arena = self.arena
        slot = pack[:, 7].astype(np.int32)
        pids = block_ids[slot[slot >= 0]]
        pids = pids[pids >= 0]
        kfs = arena.pt_obs_kf[pids[arena.pt_valid[pids]]].ravel()
        kfs = kfs[kfs >= 0]
        if len(kfs) == 0:
            return
        best = int(np.argmax(np.bincount(kfs)))
        if best == self.ref_kf or not arena.kf_valid[best]:
            return
        old_ids = self._block_ids
        self.ref_kf = best
        self._rebuild_block()
        if self._pending_remap is None:
            self._pending_remap = old_ids

    # ------------------------------------------------------------------ relocalization

    def _track_lost(self, frame: torch.Tensor, timestamp) -> None:
        """One relocalization attempt (Tracker::Relocalization, tracker.cpp:826-991).
        The front-end runs on the device and its feature block comes back in one
        read; on success the device state is re-seeded from the relocalized
        pose against the rebuilt block, and chunked tracking resumes."""
        fd = self.frontend(*frame)
        f32 = torch.float32
        pack = torch.stack([fd.xy[:, 0], fd.xy[:, 1], fd.u_right, fd.octave.to(f32), fd.angle,
                            fd.valid.to(f32)], dim=-1)
        # one read: the float columns travel as their int32 bits beside the descriptors
        block = torch.cat([pack.view(torch.int32), fd.desc], dim=-1).cpu().numpy()
        cols = np.ascontiguousarray(block[:, :6]).view(np.float32)
        host = {"xy": cols[:, 0:2], "u_right": cols[:, 2], "octave": cols[:, 3].astype(np.int32),
                "angle": cols[:, 4], "valid": cols[:, 5] > 0.5,
                "desc": np.ascontiguousarray(block[:, 6:14]).view(np.uint32)}
        res = self.relocalizer.try_relocalize(host) if self.relocalizer is not None else None
        if res is None:
            self.records.append(FrameRecord(self.frame_id, timestamp, None, True, self.ref_kf))
            return
        self.state = TrackingState.OK
        self.ref_kf = res.kf
        self._last_reloc_fid = self.frame_id
        self._pending_remap = None  # the state is re-seeded below against the new block
        self._rebuild_block()
        point_ids = np.full(host["desc"].shape[0], -1, np.int32)
        point_ids[res.feat_idx] = res.point_ids
        slot = self._ids_to_slots(point_ids)
        dev = self.device
        self._dstate = DeviceTrackState(
            pose=torch.from_numpy(res.pose).to(dev),
            velocity=torch.eye(4, dtype=torch.float32, device=dev),
            desc=fd.desc,
            octave=fd.octave,
            angle=fd.angle,
            pt_pos=torch.from_numpy(self._block_pos_for_slots(slot)).to(dev),
            pt_mask=torch.from_numpy(slot >= 0).to(dev),
            assoc_slot=torch.from_numpy(slot).to(dev),
        )
        self.records.append(FrameRecord(self.frame_id, timestamp, res.pose, False, res.kf,
                                        self._rel_to_ref(res.pose, res.kf)))
        self.metrics.add(event="frame", frame_id=self.frame_id, matches=res.n_inliers,
                         inliers=res.n_inliers, relocalized=True, reloc_kf=res.kf)

    def _need_new_keyframe(self, fid: int, s: np.ndarray) -> bool:
        """NeedNewKeyFrame (tracker.cpp:1229-1309) from the device summary."""
        cfg = self.cfg
        n_inliers = int(s[17])
        if n_inliers < 15:
            return False
        frames_since = fid - self.last_kf_frame_id
        tracked_close = int(s[18])
        untracked_close = int(s[19])
        need_close = tracked_close < 100 and untracked_close > 70
        ref_ratio = 0.75 if self.arena.n_valid_kfs > 2 else 0.4
        ref_strong = self._ref_kf_tracked_strong()
        under_ratio = n_inliers < ref_strong * ref_ratio
        overdue = frames_since >= cfg.max_frames_between_kfs
        decision = overdue or (
            (under_ratio or need_close)
            and frames_since >= max(cfg.min_frames_between_kfs, 1)
            and n_inliers > 15
        )
        if decision:
            self.metrics.add(
                event="kf_decision", frame_id=fid, overdue=overdue,
                under_ratio=under_ratio, need_close=need_close,
                inliers=n_inliers, ref_strong=ref_strong,
                close_tracked=tracked_close, close_new=untracked_close,
            )
        return decision

    # ------------------------------------------------------------------ init / keyframes

    def _initialize(self, frame: torch.Tensor, timestamp) -> bool:
        """StereoInitialization (tracker.cpp:249-295): first keyframe + a point
        per stereo (or RGB-D) feature; builds the device state and the local block."""
        fd = self.frontend(*frame)
        host = {k: getattr(fd, k).cpu().numpy()
                for k in ("xy", "angle", "octave", "desc", "valid", "u_right", "depth")}
        host["desc"] = host["desc"].view(np.uint32)
        has_depth = (host["depth"] > 0) & host["valid"]
        if (host["valid"].sum() < self.cfg.tracker.min_init_features
                or has_depth.sum() < self.cfg.tracker.min_init_stereo):
            return False
        pose = np.eye(4, dtype=np.float32)
        n = len(host["depth"])
        point_ids = np.full(n, -1, np.int32)
        kf = self.arena.add_keyframe(
            pose, self.frame_id, timestamp,
            host["xy"], host["u_right"], host["depth"],
            host["octave"].astype(np.int16), host["angle"], host["desc"],
            host["valid"], point_ids.copy(),
        )
        idx = np.nonzero(has_depth)[0]
        pids = self._create_points_from_stereo(
            kf, idx, pose, host["xy"], host["depth"], host["octave"], host["desc"])
        point_ids[idx] = pids
        self.local_mapper.note_new_points(pids, kf)
        self.arena.kf_point_idx[kf, :n] = point_ids
        self._rebuild_block()
        slot = self._ids_to_slots(point_ids)
        dev = self.device
        self._dstate = DeviceTrackState(
            pose=torch.from_numpy(pose).to(dev),
            velocity=torch.eye(4, dtype=torch.float32, device=dev),
            desc=fd.desc,
            octave=fd.octave,
            angle=fd.angle,
            pt_pos=torch.from_numpy(self._block_pos_for_slots(slot)).to(dev),
            pt_mask=torch.from_numpy(slot >= 0).to(dev),
            assoc_slot=torch.from_numpy(slot).to(dev),
        )
        self.records.append(FrameRecord(self.frame_id, timestamp, pose, False, kf,
                                        np.eye(4, dtype=np.float64)))
        self.ref_kf = kf
        self.ref_kf_tracked = int(has_depth.sum())
        self.last_kf_frame_id = self.frame_id
        if self.on_new_keyframe:
            self.on_new_keyframe(kf)
        return True

    def _create_points_from_stereo(self, kf, feat_idx, pose, xy, depth, octave, desc) -> np.ndarray:
        """Vectorized point creation from stereo depth (tracker.cpp:262-283)."""
        arena = self.arena
        cfg = self.cfg
        z = depth[feat_idx]
        u = xy[feat_idx, 0]
        v = xy[feat_idx, 1]
        x = (u - self.K.cx) * z / self.K.fx
        y = (v - self.K.cy) * z / self.K.fy
        Twc = np.linalg.inv(pose)
        pos = (Twc[:3, :3] @ np.stack([x, y, z], 0)).T + Twc[:3, 3]
        delta = pos - Twc[:3, 3]
        dist = np.linalg.norm(delta, axis=1)
        sf = cfg.orb.scale_factor
        max_dist = dist * (sf ** octave[feat_idx].astype(np.float32))
        min_dist = max_dist / (sf ** (cfg.orb.num_levels - 1))
        pids = arena.add_points(
            pos, desc[feat_idx], kf, delta / np.maximum(dist, 1e-9)[:, None], min_dist, max_dist,
        )
        arena.associate_batch(kf, np.asarray(feat_idx), pids)
        return pids

    def _ref_kf_tracked_strong(self) -> int:
        """Reference-KF map points with >= min_obs observations (TrackedMapPoints)."""
        if self.ref_kf < 0:
            return 0
        arena = self.arena
        min_obs = 3 if arena.n_valid_kfs > 2 else 2
        pids = arena.kf_point_idx[self.ref_kf]
        pids = pids[pids >= 0]
        if len(pids) == 0:
            return 0
        return int((arena.pt_valid[pids] & (arena.pt_obs_count[pids] >= min_obs)).sum())

    def _create_keyframe(self, fid, ts, pose, pack, desc, block_ids, pack_dev, desc_dev,
                         ba_data=None, tri_data=None, fuse_data=None, defer=False) -> int:
        """CreateNewKeyFrame (tracker.cpp:1311-1379) for a synced frame, from the
        host copy of its feature pack. `block_ids` is the block layout the
        frame's chunk ran with (pack slots index it). pack_dev / desc_dev are the
        frame's feature block on the device, for the keyframe store; *_data are
        the mapper's in-flight results as the fetch read them back. defer=True
        queues the mapper's heavy stage in `_deferred`."""
        arena = self.arena
        cfg = self.cfg
        xy = pack[:, 0:2]
        u_right = pack[:, 2]
        depth = pack[:, 3]
        octave = pack[:, 4].astype(np.int16)
        angle = pack[:, 5]
        valid = pack[:, 6] > 0.5
        slot = pack[:, 7].astype(np.int32)
        fuse = pack[:, 8].astype(np.int32)
        # fuse re-detections into existing points before considering new ones
        slot = np.where(slot >= 0, slot, fuse)
        point_ids = np.where(slot >= 0, block_ids[np.maximum(slot, 0)], -1).astype(np.int32)
        point_ids[point_ids >= 0] = np.where(
            arena.pt_valid[point_ids[point_ids >= 0]], point_ids[point_ids >= 0], -1
        )
        kf = arena.add_keyframe(pose, fid, ts, xy, u_right, depth, octave, angle, desc, valid,
                                point_ids.copy())
        # device-to-device copy of the chunk's feature block into the keyframe
        # store; the mapper's programs gather it by index
        self.local_mapper.kf_store.set_from_device(kf, pack_dev, desc_dev)
        # new points from stereo depth (tracker.cpp:1340-1373): every unassociated
        # close feature, padded with the nearest far ones up to 100
        cand = np.nonzero((depth > 0) & valid & (point_ids < 0))[0]
        cand = cand[np.argsort(depth[cand], kind="stable")]
        n_close = int((depth[cand] < cfg.depth_threshold).sum())
        cand = cand[: max(n_close, 100)]
        if len(cand):
            pids = self._create_points_from_stereo(kf, cand, pose, xy, depth, octave, desc)
            point_ids[cand] = pids
            self.local_mapper.note_new_points(pids, kf)
        arena.kf_point_idx[kf] = point_ids
        # the block rebuild below selects points by the refreshed stats
        self._update_point_stats(point_ids[point_ids >= 0])
        self.ref_kf = kf
        self.ref_kf_tracked = int((point_ids >= 0).sum())
        self.last_kf_frame_id = fid
        if self.on_new_keyframe:
            settled = self.local_mapper.n_finalized
            with self.timers.time("loop"), trace_span("tracker/loop"):
                self.on_new_keyframe(kf)
            if self.local_mapper.n_finalized != settled:
                # the hook settled the mapper (a loop candidate passed, or a
                # global BA was merged): its in-flight results are applied, and
                # the drain's copies belong to no pending entry any more
                ba_data = tri_data = fuse_data = None
        with self.timers.time("keyframe"), trace_span("tracker/keyframe"):
            self.local_mapper.process_keyframe(
                kf, prefetched_ba=ba_data, prefetched_tri=tri_data, prefetched_fuse=fuse_data,
                defer_queue=self._deferred if defer else None)
        self.metrics.add(
            event="keyframe", frame_id=fid, kf=kf, tracked_points=self.ref_kf_tracked,
            ba=dict(self.local_mapper.last_ba_stats),
            triangulation=dict(self.local_mapper.last_triangulation),
        )
        old_ids = self._block_ids
        self._rebuild_block()
        # the device state still indexes the pre-rebuild block; it is remapped
        # before the next chunk runs (keep the earliest pre-rebuild ids)
        if self._pending_remap is None:
            self._pending_remap = old_ids
        return kf

    @staticmethod
    def _remap_program(state: DeviceTrackState, perm: torch.Tensor, new_pos: torch.Tensor) -> DeviceTrackState:
        """On-device slot translation after a block rebuild: slot' = perm[slot]
        (-1 when the point left the block); tracked positions refreshed from the
        new block."""
        slot_old = state.assoc_slot
        slot = torch.where(slot_old >= 0, perm[torch.clamp(slot_old, min=0).long()], torch.full_like(slot_old, -1))
        has = slot >= 0
        pos = new_pos[torch.clamp(slot, min=0).long()]
        return state._replace(assoc_slot=slot, pt_mask=has,
                              pt_pos=torch.where(has[:, None], pos, torch.zeros_like(pos)))

    def _remap_device_state(self, old_ids: np.ndarray) -> None:
        if self._dstate is None:
            return
        new_slots_of_old = self._ids_to_slots(np.where(old_ids >= 0, old_ids, -1)).astype(np.int32)
        self._dstate = self._remap_program(
            self._dstate, torch.from_numpy(new_slots_of_old).to(self.device), self._block.pos)

    # ------------------------------------------------------------------ local map block

    def _rebuild_block(self) -> None:
        """Assemble the device point block from the local map (UpdateLocalKeyFrames/
        Points, tracker.cpp:1002-1134): keyframes sharing observations with the
        reference keyframe vote, the set expands with each voter's best covisible
        neighbour up to the cap; an over-cap block keeps the best-observed points."""
        arena = self.arena
        kf = self.ref_kf if self.ref_kf >= 0 else arena.num_kfs - 1
        kf_cap = self.cfg.tracker.local_map_kf_cap
        votes = arena.covisibility_counts(kf)
        voters = np.nonzero(votes > 0)[0]
        voters = voters[np.argsort(-votes[voters], kind="stable")]
        local = [kf]
        in_set = {kf}
        for v in voters[: kf_cap - 1]:
            local.append(int(v))
            in_set.add(int(v))
        for v in list(local[1:]):
            if len(local) >= kf_cap:
                break
            for nb in arena.covisible_keyframes(v, min_shared=15, max_n=10):
                if int(nb) not in in_set:
                    local.append(int(nb))
                    in_set.add(int(nb))
                    break
        kfs = np.asarray(local, np.int64)
        pid_set = arena.kf_point_idx[kfs].reshape(-1)
        pid_set = np.unique(pid_set[pid_set >= 0])
        pid_set = pid_set[arena.pt_valid[pid_set]]
        cap = self.cfg.capacity.local_window_points
        if len(pid_set) > cap:
            # survivors: most recent observing keyframe first, then observation count
            last_obs = arena.pt_obs_kf[pid_set].max(axis=1).astype(np.int64)
            obs_n = np.minimum(arena.pt_obs_count[pid_set], 63).astype(np.int64)
            keep = np.argsort(-(last_obs * 64 + obs_n), kind="stable")[:cap]
            self.metrics.add(event="cap_clip", site="local_block",
                             kept=cap, dropped=int(len(pid_set) - cap))
            pid_set = np.sort(pid_set[keep])
        P = cap
        n = len(pid_set)
        ids = np.full(P, -1, np.int32)
        ids[:n] = pid_set
        pos = np.zeros((P, 3), np.float32)
        normal = np.zeros((P, 3), np.float32)
        min_dist = np.zeros(P, np.float32)
        max_dist = np.zeros(P, np.float32)
        desc = np.zeros((P, 8), np.uint32)
        pos[:n] = arena.pt_pos[pid_set]
        normal[:n] = arena.pt_normal[pid_set]
        min_dist[:n] = arena.pt_min_dist[pid_set]
        max_dist[:n] = arena.pt_max_dist[pid_set]
        desc[:n] = arena.pt_desc[pid_set]
        dev = self.device
        self._block = track_ops.PointBlock(
            pos=torch.from_numpy(pos).to(dev),
            desc=torch.from_numpy(desc.view(np.int32)).to(dev),
            normal=torch.from_numpy(normal).to(dev),
            min_dist=torch.from_numpy(min_dist).to(dev),
            max_dist=torch.from_numpy(max_dist).to(dev),
            mask=torch.from_numpy(ids >= 0).to(dev),
        )
        self._block_ids = ids
        self._block_pos_host = pos

    def _ids_to_slots(self, point_ids: np.ndarray) -> np.ndarray:
        lookup = np.full(self.arena.num_pts + 1, -1, np.int32)
        valid_slots = np.nonzero(self._block_ids >= 0)[0]
        lookup[self._block_ids[valid_slots]] = valid_slots
        out = np.full(len(point_ids), -1, np.int32)
        has = point_ids >= 0
        out[has] = lookup[point_ids[has]]
        return out

    def _block_pos_for_slots(self, slot: np.ndarray) -> np.ndarray:
        pos = np.zeros((len(slot), 3), np.float32)
        has = slot >= 0
        pos[has] = self._block_pos_host[slot[has]]
        return pos

    def _update_point_stats(self, pids: np.ndarray) -> None:
        """MapPoint::UpdateNormalAndDepth + ComputeDistinctiveDescriptors
        (map_point.cpp:249-304, :311-354), vectorized over all touched points."""
        arena = self.arena
        if len(pids) == 0:
            return
        pids = np.unique(pids)
        obs_kf = arena.pt_obs_kf[pids]
        obs_ft = arena.pt_obs_feat[pids]
        has = obs_kf >= 0
        kf_s = np.maximum(obs_kf, 0)
        ft_s = np.maximum(obs_ft, 0)
        # normal: mean viewing direction over observations
        R = arena.kf_pose[kf_s, :3, :3]
        t = arena.kf_pose[kf_s, :3, 3]
        kf_centers = -np.einsum("noji,noj->noi", R, t)
        delta = arena.pt_pos[pids][:, None, :] - kf_centers
        norm = np.linalg.norm(delta, axis=-1, keepdims=True)
        dirs = np.where(has[..., None], delta / np.maximum(norm, 1e-9), 0.0)
        mean_dir = dirs.sum(axis=1)
        mean_norm = np.linalg.norm(mean_dir, axis=-1, keepdims=True)
        arena.pt_normal[pids] = mean_dir / np.maximum(mean_norm, 1e-9)
        # scale-invariance range from the newest observation
        newest = np.argmax(np.where(has, obs_kf, -1), axis=1)
        ar = np.arange(len(pids))
        d_new = norm[ar, newest, 0]
        oct_new = arena.kf_octave[kf_s[ar, newest], ft_s[ar, newest]].astype(np.float32)
        sf = self.cfg.orb.scale_factor
        max_dist = d_new * (sf ** oct_new)
        arena.pt_max_dist[pids] = max_dist
        arena.pt_min_dist[pids] = max_dist / (sf ** (self.cfg.orb.num_levels - 1))
        # distinctive descriptor: min median Hamming among the first 16 observations
        Ocap = min(16, kf_s.shape[1])
        kf_c, ft_c, has_c = kf_s[:, :Ocap], ft_s[:, :Ocap], has[:, :Ocap]
        descs = arena.kf_desc[kf_c, ft_c]                      # (n, Oc, 8) uint32
        x = descs[:, :, None, :] ^ descs[:, None, :, :]
        ham = np.bitwise_count(x).sum(axis=-1).astype(np.float32)
        pair_ok = has_c[:, :, None] & has_c[:, None, :]
        ham = np.where(pair_ok, ham, np.inf)
        srt = np.sort(ham, axis=2)
        cnt = pair_ok.sum(axis=2)
        mid = np.maximum(cnt - 1, 0) // 2
        med = np.take_along_axis(srt, mid[:, :, None], axis=2)[:, :, 0]
        med = np.where(has_c, med, np.inf)
        best = np.argmin(med, axis=1)
        arena.pt_desc[pids] = descs[ar, best]

    # ------------------------------------------------------------------ export

    def _rel_to_ref(self, pose: np.ndarray, ref_kf: int) -> np.ndarray:
        """Tcr = Tcw @ Trw^-1 against the ref keyframe's current pose (tracker.cpp:629-642)."""
        Trw = self.arena.kf_pose[ref_kf].astype(np.float64)
        R, t = Trw[:3, :3], Trw[:3, 3]
        inv = np.eye(4, dtype=np.float64)
        inv[:3, :3] = R.T
        inv[:3, 3] = -R.T @ t
        return pose.astype(np.float64) @ inv

    def trajectory_poses(self) -> np.ndarray:
        """Per-frame Tcw reconstructed as Tcr @ Trw from the final keyframe poses
        (SaveTrajectoryKITTI semantics); lost frames repeat the previous pose."""
        out = []
        prev = np.eye(4, dtype=np.float32)
        for r in self.records:
            if r.pose is not None:
                if r.rel_pose is not None:
                    Trw = self.arena.effective_kf_pose(r.ref_kf)
                    prev = (r.rel_pose @ Trw).astype(np.float32)
                else:
                    prev = r.pose
            out.append(prev.copy())
        return np.stack(out)
