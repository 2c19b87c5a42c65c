"""Pipeline depth 2 of the port's StereoTracker against the reference's
(slam_framework_tpu/pipeline/tracker.py:141-155, 228-240, 435-545, 692-802,
967-1058; pipeline/local_mapper.py:122-205).

The setting of tests/test_torch_slice.py with the mapper on: the same
(port-rendered) 640x240 pixels through both trackers, 800 features, 4 levels,
sync_every=4, BA capacities 16 / 512 / 2048, 22 frames. `MATURE_MAP_KFS` is set
to 2 on both instances, so depth 2 starts after the second keyframe (frame 5):
chunk 9-12 primes the pipeline. Frames 14-15 are a uniform gray pair, in chunk
13-16, which is fetched and processed while chunk 17-20 is buffered: the loss
drops that buffered chunk, recorded lost without a relocalization attempt, and
the next frame (21) is the first attempt (no relocalizer: it stays lost).

Each instance's `_dispatch`, `_fetch`, `_run_deferred`, `_rebuild_block`,
`_track_lost` and its mapper's `_cull_keyframes` log an event. Tolerances: the
same event sequence, keyframe frame ids and lost frame ids; map points within
2%; per-frame camera translation within 1 cm in the median over the frames
tracked before the loss. Keyframe culling runs after the block rebuild at depth
2 (before it at depth 1). The three runs (the reference's and the port's at
depth 2 and 1) take a thread each.

The port at `pipeline_depth=1` on the same frames runs the serial order: each
chunk is fetched right after its dispatch, nothing is deferred, and the frames
17-20 each make an attempt. No keyframe is culled on these frames, so the
depth moves host work only: its records up to the loss are bit-equal to the
depth-2 run's. The serial path is held against the reference by the parity
tests whose maps stay under `MATURE_MAP_KFS` keyframes, so that the port's
tracker never leaves depth 1 there: tests/test_torch_slice.py and
tests/test_torch_rgbd.py (at most 6 keyframes).

At sync_every=8 a chunk may make two keyframes. Both trackers then also run
17 loss-free frames of the same world at sync_every=8 with `MATURE_MAP_KFS`
set to 1, so depth 2 starts at the first chunk (1-8), which is processed with
its two keyframes deferred while chunk 9-16 computes. The schedule then also
logs the mapper's write-backs (`flush_ba` and `apply_pending_triangulation`,
each call with the number of results it lands) and each keyframe's heavy
stage (at its triangulation launch). In the reference both heavy stages of
a two-keyframe chunk run back to back and both BAs land at the next fetch;
the port's second heavy stage first lands the triangulation and the BA the
first one launched (pipeline/local_mapper.py), and that landing is the one
difference the schedules may show. Keyframes, points and poses are held with
the tolerances above.
"""

import inspect
import json
import os
import threading

import numpy as np
import pytest
import torch

from slam_framework_tpu.config import CameraConfig as JCam, CapacityConfig as JCap, OrbConfig as JOrb
from slam_framework_tpu.config import SlamConfig as JCfg
from slam_framework_tpu.pipeline.tracker import StereoTracker as JTracker
from slam_framework_torch import config as tconf
from slam_framework_torch.io import synthetic
from slam_framework_torch.pipeline.kf_store import DeviceKFStore
from slam_framework_torch.pipeline.local_mapper import LocalMapper
from slam_framework_torch.pipeline.mono_tracker import MonoTracker
from slam_framework_torch.pipeline.tracker import StereoTracker
from slam_framework_torch.utils import observability


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; torch's default of one
    thread per core in each of them oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CAM = dict(fx=400.0, fy=400.0, cx=320.0, cy=120.0, width=640, height=240, fps=10.0, bf=400.0 * 0.54)
CAP = dict(max_keyframes=64, max_map_points=65536, max_features=1024, local_window_points=8192,
           ba_cams=16, ba_points=512, ba_obs=2048)
N = 22
GRAY = range(14, 16)
DROPPED = range(17, 21)   # the chunk buffered behind the lost one
MATURE = 2
EVENTS = (("_dispatch", "dispatch"), ("_fetch", "fetch"), ("_run_deferred", "deferred"),
          ("_rebuild_block", "rebuild"), ("_track_lost", "attempt"))
N8, MATURE8 = 17, 1   # the sync_every=8 runs


def _instrument_mapper(mapper, log):
    """Log the mapper's write-backs with the results each lands, and each
    keyframe's heavy stage at its triangulation launch."""
    for name, event, pending in (("flush_ba", "flush_ba", "_ba_pendings"),
                                 ("apply_pending_triangulation", "apply_tri", "_tri_pending")):
        inner = getattr(mapper, name)

        def logged(*a, inner=inner, event=event, pending=pending, **k):
            log.append((event, len(getattr(mapper, pending))))
            return inner(*a, **k)

        setattr(mapper, name, logged)
    launch = mapper._dispatch_triangulation

    def heavy(kf):
        log.append(("heavy", int(kf)))
        return launch(kf)

    mapper._dispatch_triangulation = heavy


def _instrument(tracker, log):
    """Log the schedule: each wrapped method appends its event, attempts with their frame."""
    def wrap(obj, name, event):
        inner = getattr(obj, name)

        def logged(*a, **k):
            log.append((event, tracker.frame_id) if event == "attempt" else event)
            return inner(*a, **k)

        setattr(obj, name, logged)

    for name, event in EVENTS:
        wrap(tracker, name, event)
    wrap(tracker.local_mapper, "_cull_keyframes", "cull_kfs")


def _run(tracker, feed, world, n=N, mature=MATURE, mapper_log=False):
    tracker.MATURE_MAP_KFS = mature
    log = []
    _instrument(tracker, log)
    if mapper_log:
        _instrument_mapper(tracker.local_mapper, log)
    for f in range(n):
        tracker.track(*feed[f], world.timestamps[f])
    tracker.flush()
    return {"tracker": tracker, "log": log}


@pytest.fixture(scope="module")
def runs():
    tcfg = tconf.SlamConfig(camera=tconf.CameraConfig(**CAM), orb=tconf.OrbConfig(num_features=800, num_levels=4),
                            capacity=tconf.CapacityConfig(**CAP))
    jcfg = JCfg(camera=JCam(**CAM), orb=JOrb(num_features=800, num_levels=4), capacity=JCap(**CAP))
    world = synthetic.make_world(num_frames=N + 14, cam=tcfg.camera, seed=1, speed=0.8, yaw_rate=0.004)
    pairs = [world.stereo_pair(f) for f in range(N)]
    gray = np.full_like(pairs[0][0], 90)
    feed = [(gray, gray) if f in GRAY else pairs[f] for f in range(N)]
    sync8 = dict(n=N8, mature=MATURE8, mapper_log=True)
    makers = {
        "ref": (lambda: JTracker(jcfg, sync_every=4), feed, {}),
        "port2": (lambda: StereoTracker(tcfg, sync_every=4, device="cpu"), feed, {}),
        "port1": (lambda: StereoTracker(tcfg, sync_every=4, pipeline_depth=1, device="cpu"), feed, {}),
        "ref8": (lambda: JTracker(jcfg, sync_every=8), pairs, sync8),
        "port8": (lambda: StereoTracker(tcfg, sync_every=8, device="cpu"), pairs, sync8),
    }
    out, errors = {}, []

    def run(name):
        make, frames, kw = makers[name]
        try:
            out[name] = _run(make(), frames, world, **kw)
        except BaseException as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(name,)) for name in makers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    assert not any(t.is_alive() for t in threads), "a tracker run did not finish in 900 s"
    if errors:
        raise errors[0]
    return out


def _centers(poses):
    return np.stack([np.linalg.inv(T.astype(np.float64))[:3, 3] for T in poses])


def test_signature_and_mature_map_match_the_reference():
    for cls in (StereoTracker, JTracker):
        assert inspect.signature(cls).parameters["pipeline_depth"].default == 2
    assert StereoTracker.MATURE_MAP_KFS == JTracker.MATURE_MAP_KFS == 12


def test_same_schedule(runs):
    port, ref = runs["port2"]["log"], runs["ref"]["log"]
    assert port == ref
    # the buffered chunk is dropped: the first attempt is the frame after it
    assert [e[1] for e in port if isinstance(e, tuple)] == [DROPPED[-1] + 1]
    assert "deferred" in port


def test_same_keyframes_and_lost_frames(runs):
    tt, jt = runs["port2"]["tracker"], runs["ref"]["tracker"]
    assert len(tt.records) == len(jt.records) == N
    np.testing.assert_array_equal(tt.arena.kf_frame_id[: tt.arena.num_kfs], jt.arena.kf_frame_id[: jt.arena.num_kfs])
    np.testing.assert_array_equal(tt.arena.kf_valid[: tt.arena.num_kfs], jt.arena.kf_valid[: jt.arena.num_kfs])
    assert tt.arena.num_kfs >= 4
    lost = [r.frame_id for r in tt.records if r.lost]
    assert lost == [r.frame_id for r in jt.records if r.lost] == list(range(GRAY[0], N))


def test_map_points_within_2_percent(runs):
    tt, jt = runs["port2"]["tracker"], runs["ref"]["tracker"]
    assert abs(tt.arena.n_valid_pts - jt.arena.n_valid_pts) <= 0.02 * jt.arena.n_valid_pts
    assert tt.local_mapper.totals["ba_applied"] >= 1


def test_translation_before_the_loss_within_1cm_median(runs):
    tt, jt = runs["port2"]["tracker"], runs["ref"]["tracker"]
    before = slice(0, GRAY[0])
    d = np.linalg.norm(_centers(tt.trajectory_poses()[before]) - _centers(jt.trajectory_poses()[before]), axis=1)
    assert np.median(d) < 0.01, d


def _windows(log, n):
    return [log[i: i + n] for i in range(len(log) - n + 1)]


def test_keyframe_culling_after_the_block_rebuild_at_depth_2(runs):
    """At depth 2 a keyframe's culling is in the deferred stage, after its block
    rebuild and the next dispatch (after the rebuild alone in the lost chunk,
    which dispatches nothing); at depth 1 it precedes the rebuild."""
    for log in (runs["port2"]["log"], runs["ref"]["log"]):
        assert ["rebuild", "dispatch", "deferred", "cull_kfs"] in _windows(log, 4), log
        assert ["rebuild", "deferred", "cull_kfs"] in _windows(log, 3), log
    log = runs["port1"]["log"]
    assert ["cull_kfs", "rebuild"] in _windows(log, 2) and ["rebuild", "deferred"] not in _windows(log, 2), log


def test_depth_1_runs_the_serial_order(runs):
    port1, port2 = runs["port1"], runs["port2"]
    log = port1["log"]
    assert "deferred" not in log
    ops = [e for e in log if e in ("dispatch", "fetch")]
    assert ops == ["dispatch", "fetch"] * (len(ops) // 2)  # each chunk fetched before the next dispatch
    assert [e[1] for e in log if isinstance(e, tuple)] == list(range(DROPPED[0], N))
    a, b = port1["tracker"], port2["tracker"]
    assert [r.frame_id for r in a.records if r.lost] == list(range(GRAY[0], N))
    np.testing.assert_array_equal(a.arena.kf_frame_id[: a.arena.num_kfs], b.arena.kf_frame_id[: b.arena.num_kfs])
    assert not a.local_mapper.totals["culled_keyframes"]
    for ra, rb in zip(a.records[: GRAY[0]], b.records[: GRAY[0]]):
        assert (ra.frame_id, ra.lost, ra.ref_kf) == (rb.frame_id, rb.lost, rb.ref_kf)
        np.testing.assert_array_equal(ra.pose, rb.pose)


def _deferred_stages(log):
    """The events of each deferred stage: from a `deferred` to the next fetch or dispatch."""
    stages, cur = [], None
    for e in log:
        if e == "deferred":
            cur = []
            stages.append(cur)
        elif e in ("fetch", "dispatch"):
            cur = None
        elif cur is not None:
            cur.append(e)
    return stages


def _strip_landings(log):
    """The log without the landing (the two write-backs the port's heavy stage
    makes before its triangulation launch), and what each landing landed."""
    out, landed = [], []
    for e in log:
        if isinstance(e, tuple) and e[0] == "heavy":
            assert [x[0] for x in out[-2:]] == ["apply_tri", "flush_ba"], out[-2:]
            landed.append((e[1], out[-2][1], out[-1][1]))
            del out[-2:]
        out.append(e)
    return out, landed


def _counts_dropped(log):
    return [e[0] if isinstance(e, tuple) and e[0] in ("flush_ba", "apply_tri") else e for e in log]


def _landed(log, event):
    return sum(e[1] for e in log if isinstance(e, tuple) and e[0] == event)


def test_sync_8_schedule_is_the_references_plus_the_landing(runs):
    """A chunk with two keyframes at depth 2: in the reference both heavy stages
    run back to back after the next dispatch, with no write-back between them,
    and both BAs land at the next fetch. The port's one departure: its second
    heavy stage first lands the triangulation and the BA the first one launched
    (pipeline/local_mapper.py). Without that landing the schedules are the same
    call for call, and every result lands exactly once in both."""
    port, ref = runs["port8"]["log"], runs["ref8"]["log"]
    two = [st for st in _deferred_stages(ref) if sum(isinstance(e, tuple) and e[0] == "heavy" for e in st) >= 2]
    assert two, ref  # the reference makes a chunk with two keyframes at depth 2
    for st in two:
        assert not any(isinstance(e, tuple) and e[0] in ("flush_ba", "apply_tri") for e in st), st
    assert ("flush_ba", 2) in ref  # the reference lands the two BAs together
    stripped, landed = _strip_landings(port)
    seconds = {st_heavy[1][1] for st_heavy in ([e for e in st if isinstance(e, tuple) and e[0] == "heavy"]
                                               for st in two)}
    assert [(kf, tri, ba) for kf, tri, ba in landed if tri or ba] == [(kf, 1, 1) for kf in sorted(seconds)], landed
    assert _counts_dropped(stripped) == _counts_dropped(ref)
    for event in ("flush_ba", "apply_tri"):
        assert _landed(port, event) == _landed(ref, event)
    assert ("flush_ba", 2) not in port


def test_sync_8_same_keyframes_points_and_poses(runs):
    tt, jt = runs["port8"]["tracker"], runs["ref8"]["tracker"]
    assert len(tt.records) == len(jt.records) == N8
    np.testing.assert_array_equal(tt.arena.kf_frame_id[: tt.arena.num_kfs], jt.arena.kf_frame_id[: jt.arena.num_kfs])
    np.testing.assert_array_equal(tt.arena.kf_valid[: tt.arena.num_kfs], jt.arena.kf_valid[: jt.arena.num_kfs])
    assert [r.frame_id for r in tt.records if r.lost] == [r.frame_id for r in jt.records if r.lost] == []
    assert abs(tt.arena.n_valid_pts - jt.arena.n_valid_pts) <= 0.02 * jt.arena.n_valid_pts
    d = np.linalg.norm(_centers(tt.trajectory_poses()) - _centers(jt.trajectory_poses()), axis=1)
    assert np.median(d) < 0.01, d


def test_fetch_refuses_a_queued_deferred_stage():
    """Every caller runs the deferred queue before the next fetch; a fetch with
    work still queued would read the mapper's results without that work's launches."""
    cfg = tconf.SlamConfig(camera=tconf.CameraConfig(**CAM), capacity=tconf.CapacityConfig(**CAP))
    tracker = StereoTracker(cfg, sync_every=8, device="cpu")
    ran = []
    tracker._deferred.append(("mapper", lambda: ran.append(1)))
    with pytest.raises(AssertionError, match="deferred"):
        tracker._fetch()
    assert not ran


def _mono_cfg():
    return tconf.SlamConfig(camera=tconf.CameraConfig(**CAM), orb=tconf.OrbConfig(num_features=200, num_levels=2),
                            capacity=tconf.CapacityConfig(max_keyframes=16, max_map_points=1024, max_features=256),
                            sensor="monocular")


def test_monocular_runs_at_depth_2_once_mature_with_a_synchronous_mapper(monkeypatch):
    mono = MonoTracker(_mono_cfg(), device="cpu")
    assert mono.pipeline_depth == 2 and mono._current_depth() == 1
    mono.arena.kf_valid[: StereoTracker.MATURE_MAP_KFS] = True
    mono.arena.num_kfs = StereoTracker.MATURE_MAP_KFS
    assert mono._current_depth() == 2 and mono._current_sync() == mono.sync_every
    stereo = LocalMapper(tconf.SlamConfig(capacity=_mono_cfg().capacity), mono.arena, mono.K, device="cpu")
    for mapper, queued in ((mono.local_mapper, False), (stereo, True)):
        ran, queue = [], []
        monkeypatch.setattr(mapper, "_heavy_stage", ran.append)
        mapper.process_keyframe(0, defer_queue=queue)
        assert [kind for kind, _ in queue] == (["mapper"] if queued else [])
        assert ran == ([] if queued else [0])
        for _kind, fn in queue:
            fn()
        assert ran == [0]


def test_mapper_and_store_take_the_card_unless_given_the_cpu(monkeypatch):
    """device=None resolves as every entry point does: the first CUDA device,
    an error without one; the CPU only when the caller names it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _mono_cfg()
    mono = MonoTracker(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalMapper(cfg, mono.arena, mono.K)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceKFStore(4, 8)
    assert LocalMapper(cfg, mono.arena, mono.K, device="cpu").kf_store.device.type == "cpu"
    assert DeviceKFStore(4, 8, device="cpu").packs.device.type == "cpu"


def test_trace_helpers_write_a_chrome_trace(tmp_path):
    """start_trace / stop_trace (the reference's utils/observability.py:130-147)
    on torch.profiler: one capture at a time, the spans in `trace.json`."""
    assert observability.stop_trace() is None
    assert observability.start_trace(str(tmp_path))
    assert not observability.start_trace(str(tmp_path))
    with observability.trace_span("tracker/deferred"):
        torch.ones(64).cumsum(0)
    prof = observability.stop_trace()
    assert [e.name for e in prof.events() if e.name == "tracker/deferred"] == ["tracker/deferred"]
    with open(os.path.join(tmp_path, observability.TRACE_FILE)) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert "tracker/deferred" in names
    assert observability.stop_trace() is None


def test_span_overlap_counts_device_time_inside_host_spans():
    """profile_main_path's overlap measure: per span name the union of its host
    ranges, the kernel time inside that union, and the part of it launched
    before a range began (us in, ms out)."""
    from types import SimpleNamespace

    from slam_framework_torch.tools.profile_main_path import span_overlap

    def ev(name, a, b):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b))

    spans = [ev("tracker/deferred", 0, 100), ev("tracker/deferred", 50, 150), ev("tracker/deferred", 300, 400),
             ev("tracker/dispatch", 150, 300)]
    kernels = [ev("k", 90, 160), ev("k", 200, 210), ev("k", 390, 500)]
    got = span_overlap(spans, kernels, launch_us=[80, 190, 250])
    assert got["tracker/deferred"] == {"ranges": 3, "host_ms": 0.25, "device_ms": pytest.approx(0.07),
                                       "device_ms_queued_before": pytest.approx(0.01)}
    assert got["tracker/dispatch"] == {"ranges": 1, "host_ms": 0.15, "device_ms": pytest.approx(0.02),
                                       "device_ms_queued_before": pytest.approx(0.01)}
    assert span_overlap(spans, kernels)["tracker/deferred"]["device_ms_queued_before"] == 0.0


def test_kernel_launches_pair_kernels_with_their_launch_calls():
    """A kernel's launch is the host runtime call with its correlation id."""
    from types import SimpleNamespace

    from slam_framework_torch.tools.profile_main_path import kernel_launches

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(i, name, device, a, b):
        return SimpleNamespace(id=i, name=name, device_type=device, time_range=SimpleNamespace(start=a, end=b))

    kernels = [ev(7, "k1", cuda, 20, 30), ev(8, "k2", cuda, 40, 50), ev(9, "k3", cuda, 60, 70)]
    events = kernels + [ev(7, "cudaLaunchKernel", cpu, 5, 6), ev(8, "cuLaunchKernel", cpu, 45, 46),
                        ev(9, "aten::add", cpu, 1, 2)]
    launch_us, counts = kernel_launches(events, kernels)
    np.testing.assert_array_equal(launch_us[:2], [5, 45])
    assert np.isnan(launch_us[2]) and counts == {"found": 2, "after_kernel_start": 1}


def test_a_chunks_second_keyframe_lands_the_first_ones_ba_before_its_own(monkeypatch):
    """At depth 2 both heavy stages of a chunk with two keyframes (sync_every=8)
    run after the next dispatch; the second lands the BA the first launched
    before it assembles its own (the reference lands both at the next fetch).
    Serially (no queue) the second keyframe's critical part has landed it."""
    cfg = tconf.SlamConfig(camera=tconf.CameraConfig(**CAM), capacity=tconf.CapacityConfig(**CAP))
    for deferred in (True, False):
        mapper = StereoTracker(cfg, sync_every=8, device="cpu").local_mapper
        seen, landed = [], []

        def local_ba(kf, mapper=mapper, seen=seen):
            seen.append((kf, [p["kf"] for p in mapper._ba_pendings]))
            mapper._ba_pendings.append({"kf": kf})

        monkeypatch.setattr(mapper, "_local_ba", local_ba)
        monkeypatch.setattr(mapper, "_apply_ba", lambda pending, prefetched=None, landed=landed: landed.append(pending["kf"]))
        monkeypatch.setattr(mapper, "_dispatch_triangulation", lambda kf: None)
        monkeypatch.setattr(mapper, "_cull_keyframes", lambda kf: None)
        queue = [] if deferred else None
        mapper.process_keyframe(1, defer_queue=queue)
        mapper.process_keyframe(2, defer_queue=queue)
        if deferred:
            assert [kind for kind, _ in queue] == ["mapper", "mapper"] and seen == []
            for _kind, fn in queue:
                fn()
        assert seen == [(1, []), (2, [])] and landed == [1]
