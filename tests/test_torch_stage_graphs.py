"""The tracker's staged frame program (pipeline/stage_graphs.py) on the CPU.

On the card each stage of a dispatched frame (the front-end's two, motion, the
fallback, the local map) is a CUDA graph replayed over tensors held at fixed
addresses; on the CPU the same stage bodies run directly over the same held
tensors, so this file holds the plumbing the card replays: the staged frame
copied in, the device state and the block written in place, and each frame's
summary, pack and descriptors leaving as fresh tensors while the next chunk
runs at depth 2.

The corridor world of tests/test_torch_pipeline_depth.py at a smaller camera
(480x180, 400 features on 4 levels, 512 slots, a block of 2,048 points),
sync_every=4, the port alone: 9 frames with `MATURE_MAP_KFS` set to 1, so both
chunks run at depth 2 and chunk 5-8 runs after the keyframe made in chunk 1-4
and its block rebuild and remap. The fallback stage is forced on every other
frame.
Tolerance: none — every frame's outputs and next state equal, bit for bit,
what `_track_core` gives when called directly on the frame's state, features
and block.
"""

import copy

import pytest
import torch

from slam_framework_torch import config as tconf
from slam_framework_torch.io import synthetic
from slam_framework_torch.pipeline import stage_graphs, tracker as tracker_mod
from slam_framework_torch.pipeline.frame import FrameData
from slam_framework_torch.pipeline.track_ops import PointBlock
from slam_framework_torch.pipeline.tracker import DeviceTrackState, StereoTracker


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CAM = dict(fx=300.0, fy=300.0, cx=240.0, cy=90.0, width=480, height=180, fps=10.0, bf=300.0 * 0.54)
CAP = dict(max_keyframes=64, max_map_points=65536, max_features=512, local_window_points=2048,
           ba_cams=16, ba_points=512, ba_obs=2048)
N = 9


def _clone(t):
    return type(t)(*(x.clone() for x in t))


@pytest.fixture(scope="module")
def run():
    cfg = tconf.SlamConfig(camera=tconf.CameraConfig(**CAM), orb=tconf.OrbConfig(num_features=400, num_levels=4),
                           capacity=tconf.CapacityConfig(**CAP))
    world = synthetic.make_world(num_frames=N, cam=cfg.camera, seed=1, speed=0.8, yaw_rate=0.004)
    tracker = StereoTracker(cfg, sync_every=4, device="cpu")
    tracker.MATURE_MAP_KFS = 1
    frames, log = [], []
    staged = tracker._run_frame

    def checked(frame, block):
        k = len(frames)
        # the fallback stage on every other frame, in both paths
        below = tracker_mod.FALLBACK_BELOW
        tracker_mod.FALLBACK_BELOW = 10**9 if k % 2 else below
        try:
            state, held_block = _clone(tracker._dstate), _clone(block)
            out = staged(frame, block)
            key = (tuple(frame.shape), frame.dtype)
            fd = _clone(tracker._stage_graphs.held[("features", key)])
            want = tracker._track_core(state, fd, held_block)
        finally:
            tracker_mod.FALLBACK_BELOW = below
        frames.append({"out": [x.clone() for x in out], "state": _clone(tracker._dstate), "want": want,
                       "frame": frame.clone(), "fd": fd, "depth": tracker._current_depth()})
        log.append("frame")
        return out

    tracker._run_frame = checked
    remap = tracker._remap_device_state

    def logged_remap(old_ids):
        log.append("remap")
        return remap(old_ids)

    tracker._remap_device_state = logged_remap
    for f in range(N):
        tracker.track(*world.stereo_pair(f), world.timestamps[f])
    # the outputs of the chunk still pending, and its frames, before the flush lands them
    summaries, packs, descs = (t.clone() for t in tracker._pending[-1][2:5])
    pending = {"summaries": summaries, "packs": packs, "descs": descs, "frames": frames[-len(summaries):]}
    tracker.flush()
    return {"tracker": tracker, "frames": frames, "log": log, "pending": pending}


def test_every_frame_is_what_track_core_gives_on_its_inputs(run):
    frames = run["frames"]
    assert len(frames) == N - 1 and sum(f["depth"] == 2 for f in frames) == N - 1
    for k, fr in enumerate(frames):
        new_state, *want = fr["want"]
        for got, exp in zip(fr["out"], want, strict=True):
            assert torch.equal(got, exp), k
        for name, got, exp in zip(DeviceTrackState._fields, fr["state"], new_state, strict=True):
            assert torch.equal(got, exp), (k, name)


def test_the_staged_front_end_is_the_front_ends_call(run):
    tracker, fr = run["tracker"], run["frames"][-1]
    direct = tracker.frontend(*fr["frame"])
    for name, got, exp in zip(FrameData._fields, fr["fd"], direct, strict=True):
        assert torch.equal(got, exp), name


def test_depth_2_chunks_run_after_a_rebuild_and_remap_and_keep_their_own_outputs(run):
    log, tracker, pending = run["log"], run["tracker"], run["pending"]
    # a keyframe after the first, whose remap of the held state precedes the last chunk
    assert tracker.arena.num_kfs >= 2 and log[-5:] == ["remap"] + ["frame"] * 4
    # the chunk still pending at the end holds its frames' own outputs
    for j, fr in enumerate(pending["frames"]):
        assert torch.equal(pending["summaries"][j], fr["out"][0]) and torch.equal(pending["packs"][j], fr["out"][1])
        assert torch.equal(pending["descs"][j], fr["out"][2])
    assert not torch.equal(pending["summaries"][0], pending["summaries"][-1])


def test_counters_count_the_frames(run):
    tracker = run["tracker"]
    assert tracker.frontend_frames == N
    assert (tracker.replayed_frames, tracker.graph_captures, tracker.fallback_replays) == (0, 0, 0)
    assert not any(r.lost for r in tracker.records) and len(tracker.records) == N


def test_assigned_state_and_block_are_copied_into_the_held_tensors(run):
    tracker = run["tracker"]
    held = tracker._dstate
    pose = held.pose.clone()
    tracker._dstate = held._replace(pose=pose + 1.0)
    assert tracker._dstate is held and torch.equal(held.pose, pose + 1.0)
    tracker._dstate = held._replace(pose=pose)
    block = tracker._block
    tracker._block = _clone(block)
    assert tracker._block is block
    with pytest.raises(ValueError):
        tracker._dstate = held._replace(desc=held.desc[:3])
    # a copy holds its own state and no stage of the original
    twin = copy.deepcopy(tracker)
    assert twin._stage_graphs.held == {} and tracker._stage_graphs.held
    assert torch.equal(twin._dstate.pose, held.pose) and twin._dstate.pose.data_ptr() != held.pose.data_ptr()


def test_held_tensors_keep_their_type_and_shapes_and_a_copy_holds_none():
    graphs = stage_graphs.StageGraphs("cpu")
    held = graphs.keep("a", (torch.arange(4),))
    assert graphs.run("b", lambda: graphs.keep("a", (torch.arange(4) * 2,))) is stage_graphs.Ran.EAGER
    assert torch.equal(held[0], torch.arange(4) * 2)
    twin = copy.deepcopy(graphs)
    assert twin.held == {} and twin.device == graphs.device
    block = PointBlock(torch.zeros(5, 3), torch.zeros(5, 8, dtype=torch.int32), torch.zeros(5, 3),
                       torch.zeros(5), torch.zeros(5), torch.ones(5, dtype=torch.bool))
    held = stage_graphs.hold(None, block)
    assert isinstance(held, PointBlock) and held.pos is not block.pos
    assert stage_graphs.hold(held, block._replace(min_dist=torch.ones(5))) is held and bool((held.min_dist == 1).all())
    with pytest.raises(ValueError):
        stage_graphs.hold(held, block._replace(mask=torch.ones(4, dtype=torch.bool)))
