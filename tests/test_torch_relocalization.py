"""The port's relocalization and map resume against the reference
(pipeline/relocalization.py, io/checkpoint.py, system.py) on the world of
tests/test_system.py.

One module fixture runs the reference `SlamSystem` for 26 frames plus 4 blank
ones (tracking is lost) and saves its map. Its arena, BoW database, keyframe
store and vocabulary are copied into a port `LoopCloser` + `Relocalizer` on the
CPU. Given the reference's own index sets (drawn from its `PRNGKey(11)` split per
candidate), `try_relocalize` on the reference front-end's features of a revisited
frame must agree exactly on the candidates, the BoW match rows and the accepted
keyframe, within 1 cm on the camera centre and within 2 on `n_inliers`;
`_guided_retry` from the same pose the same way; `ensure_bow_current` lands the
same database row.

Port-only scenarios keep the reference tests' assertions. One port system runs
them in sequence on the map the reference saved (the frames are the costly
part): it loads the map, relocalizes and tracks (tests/test_checkpoint.py:72-92,
frame numbering included), localization mode freezes the map
(tests/test_system.py:55-71), then a blackout is recovered (:99-139); its own map,
saved at the end, is read by the reference's `checkpoint.load_map` with equal
arrays. A loss on a young map resets (:142-162) in a system of its own. A newer
checkpoint format version is refused. The port's own mapping through a blackout
is the `slow` test's, and the chip smoke's. A `slow` test (run by hand) drives
the port alone through the reference's 300-frame "loop closes after
relocalization" scenario.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_framework_tpu.config import CameraConfig, CapacityConfig, OrbConfig, SlamConfig
from slam_framework_tpu.io import checkpoint as jckpt
from slam_framework_tpu.io import synthetic
from slam_framework_tpu.pipeline.relocalization import Relocalizer as JRelocalizer
from slam_framework_tpu.pipeline.tracker import TrackingState as JState
from slam_framework_tpu.system import SlamSystem as JSlamSystem
from slam_framework_torch import config as tconf, interop
from slam_framework_torch.bow.database import BowFrame as TBowFrame
from slam_framework_torch.geometry.projection import Intrinsics as TIntrinsics
from slam_framework_torch.io import checkpoint as tckpt, trajectory
from slam_framework_torch.pipeline import loop_closer as tlc, relocalization as treloc
from slam_framework_torch.pipeline.tracker import TrackingState
from slam_framework_torch.system import SlamSystem as TSlamSystem


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; torch's default of one
    thread per core in each of them oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


N_GOOD = 26      # frames mapped before the blackout (> 5 keyframes by then)
N_BLANK = 4
REVISIT = 22     # world frame the parity tests relocalize
RESUMED = range(20, 24)  # world frames fed to the port after it loads the reference's map


def _jcfg():
    return SlamConfig(
        camera=CameraConfig(fx=400.0, fy=400.0, cx=320.0, cy=120.0, width=640, height=240,
                            fps=10.0, bf=400.0 * 0.54),
        orb=OrbConfig(num_features=800, num_levels=4),
        capacity=CapacityConfig(max_keyframes=64, max_map_points=65536, max_features=1024,
                                local_window_points=8192),
        sensor="stereo",
    )


def _tcfg():
    j = _jcfg()
    return tconf.SlamConfig(camera=tconf.CameraConfig(**dataclasses.asdict(j.camera)),
                            orb=tconf.OrbConfig(**dataclasses.asdict(j.orb)),
                            capacity=tconf.CapacityConfig(**dataclasses.asdict(j.capacity)),
                            sensor="stereo")


def _K():
    c = _jcfg().camera
    return TIntrinsics(c.fx, c.fy, c.cx, c.cy, c.bf)


def _blank():
    return np.full((240, 640), 90, np.uint8)


def _centre(T):
    T = np.asarray(T, np.float64)
    return -T[:3, :3].T @ T[:3, 3]


@pytest.fixture(scope="module")
def world():
    return synthetic.make_world(num_frames=30, cam=_jcfg().camera, seed=1, speed=0.8, yaw_rate=0.004,
                                num_landmarks=2500)


@pytest.fixture(scope="module")
def ref(world, tmp_path_factory):
    """The reference system after 26 frames and 4 blank ones, its saved map, and
    the reference front-end's features of a revisited frame."""
    sys_ = JSlamSystem(_jcfg())
    for f in range(N_GOOD):
        sys_.track_stereo(*world.stereo_pair(f), world.timestamps[f])
    sys_.tracker.flush()
    for f in range(N_BLANK):
        sys_.track_stereo(_blank(), _blank(), world.timestamps[N_GOOD - 1] + 0.1 * (f + 1))
    sys_.tracker.flush()
    assert sys_.tracking_state == JState.LOST
    path = str(tmp_path_factory.mktemp("ref_ckpt") / "map.npz")
    sys_.save_map(path)
    sys_.loop_closer.ensure_bow_current()
    l, r = world.stereo_pair(REVISIT)
    fd = jax.device_get(sys_.tracker.frontend(jnp.asarray(l), jnp.asarray(r)))
    fd_host = {k: np.asarray(getattr(fd, k)) for k in ("xy", "desc", "valid", "octave", "angle", "u_right")}
    return dict(sys=sys_, path=path, fd_host=fd_host)


def _port_bow(b) -> TBowFrame:
    out = object.__new__(TBowFrame)
    out.words, out.values = np.array(b.words), np.array(b.values)
    return out


def _port_relocalizer(jsys):
    """A port LoopCloser + Relocalizer on the CPU holding copies of the reference's
    arena, database, BoW frames, keyframe store and vocabulary."""
    jc = jsys.loop_closer
    arena = interop.arena(jsys.arena)
    tc = tlc.LoopCloser(_tcfg(), arena, _K(), interop.vocabulary(jc.vocab),
                        kf_store=interop.kf_store(jc.kf_store, device="cpu"), device="cpu")
    tc.db.index = {w: list(kfs) for w, kfs in jc.db.index.items()}
    tc.db.frames = {k: _port_bow(b) for k, b in jc.db.frames.items()}
    tc.bow_frames = {k: _port_bow(b) for k, b in jc.bow_frames.items()}
    return tc, treloc.Relocalizer(_tcfg(), arena, _K(), tc, device="cpu")


def _reference_index_sets(relocalizer):
    """Hand the port the sets the reference draws: PRNGKey(11), split per
    candidate, `jax.random.choice` weighted by the mask."""
    key = [jax.random.PRNGKey(11)]

    def draw(mask, set_size):
        key[0], sub = jax.random.split(key[0])
        probs = jnp.asarray(mask).astype(jnp.float32)
        probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
        idx = jax.random.choice(sub, len(mask), shape=(treloc.N_HYPOTHESES, set_size), replace=True, p=probs)
        return torch.from_numpy(np.asarray(idx).astype(np.int64))

    relocalizer._index_sets = draw


def _recording_reference(jsys):
    jr = JRelocalizer(jsys.cfg, jsys.arena, jsys.tracker.K, jsys.loop_closer)
    rows, inner = [], jr._jit_bow_match

    def recording(*args):
        out = inner(*args)
        rows.append(np.nonzero(np.asarray(out[1]))[0])
        return out

    jr._jit_bow_match = recording
    return jr, rows


def _recording_candidates(db):
    seen, inner = [], db.detect_relocalization_candidates

    def recording(*args, **kw):
        out = inner(*args, **kw)
        seen.append(list(out))
        return out

    db.detect_relocalization_candidates = recording
    return seen


def _assert_same_reloc(got, want):
    assert got is not None and want is not None
    assert got.kf == want.kf
    assert np.linalg.norm(_centre(got.pose) - _centre(want.pose)) < 0.01
    assert abs(got.n_inliers - want.n_inliers) <= 2


def test_try_relocalize_agrees_with_reference(ref, world):
    jsys = ref["sys"]
    tc, tr = _port_relocalizer(jsys)
    _reference_index_sets(tr)
    jr, j_rows = _recording_reference(jsys)
    j_cands = _recording_candidates(jsys.loop_closer.db)
    t_cands = _recording_candidates(tc.db)
    want = jr.try_relocalize(ref["fd_host"])
    got = tr.try_relocalize(ref["fd_host"])
    assert t_cands == j_cands and j_cands[0]
    assert len(tr.last_report) == len(j_rows)
    for step, rows_j in zip(tr.last_report, j_rows):
        np.testing.assert_array_equal(step["rows"], rows_j)
    _assert_same_reloc(got, want)
    # and the pose is the revisited frame's
    assert np.linalg.norm(_centre(got.pose) - _centre(world.poses[REVISIT])) < 0.3


def test_guided_retry_agrees_with_reference(ref):
    jsys = ref["sys"]
    _, tr = _port_relocalizer(jsys)
    jr = JRelocalizer(jsys.cfg, jsys.arena, jsys.tracker.K, jsys.loop_closer)
    found = jr.try_relocalize(ref["fd_host"])
    seed = np.array(found.pose, np.float32)
    seed[:3, 3] += np.array([0.05, -0.03, 0.08], np.float32)  # a pose prior a few cm off
    want = jr._guided_retry(found.kf, seed, ref["fd_host"])
    got = tr._guided_retry(found.kf, seed, ref["fd_host"])
    _assert_same_reloc(got, want)


def test_ensure_bow_current_lands_the_same_row(ref):
    jsys = ref["sys"]
    tc, _ = _port_relocalizer(jsys)
    jc = jsys.loop_closer
    kf = int(np.nonzero(jsys.arena.kf_valid)[0][-1])
    for closer in (jc, tc):
        closer.db.erase(kf)
        closer.bow_frames.pop(kf, None)
        closer._dispatch_bow(kf)
        assert kf not in closer.db.frames
        closer.ensure_bow_current()
        assert closer._bow_pending is None
    np.testing.assert_array_equal(tc.db.frames[kf].words, jc.db.frames[kf].words)
    np.testing.assert_allclose(tc.db.frames[kf].values, jc.db.frames[kf].values, rtol=1e-6)
    assert {w: kfs for w, kfs in tc.db.index.items() if kfs} == {w: kfs for w, kfs in jc.db.index.items() if kfs}


@pytest.fixture(scope="module")
def port_run(ref, world, tmp_path_factory):
    """One port system through the reference tests' scenarios in turn, on the map
    the reference saved (the frames are the costly part): `load_map` resumes
    LOST and the revisit relocalizes and tracks, localization mode over the
    tail freezes the map, then a blackout and the revisit; its map saved at
    the end."""
    s = TSlamSystem(_tcfg(), device="cpu")
    s.load_map(ref["path"])
    n_saved = len(s.tracker.records)
    out = {"state_after_load": s.tracking_state, "relocalizer": s.tracker.relocalizer is not None,
           "n_saved": n_saved}
    fed = [-1] * n_saved  # tracker frame_id -> world frame (-1: the saved run's, or blank)
    relocalized = False
    for f in RESUMED:
        s.track_stereo(*world.stereo_pair(f), world.timestamps[f])
        fed.append(f)
        relocalized |= s.tracking_state == TrackingState.OK
    s.tracker.flush()
    out["resume"] = dict(relocalized=relocalized, last_frame_id=s.tracker.records[-1].frame_id,
                         n_poses=s.frame_poses().shape[0], records=list(s.tracker.records[n_saved:]))
    kfs_before = s.arena.n_valid_kfs
    s.activate_localization_mode()
    for f in range(RESUMED[-1] + 1, world.num_frames):
        s.track_stereo(*world.stereo_pair(f), world.timestamps[f])
        fed.append(f)
    s.tracker.flush()
    out["localization"] = dict(resets=s.n_resets, kfs_before=kfs_before, kfs_after=s.arena.n_valid_kfs,
                               state=s.tracking_state)
    s.deactivate_localization_mode()
    for f in range(N_BLANK):
        s.track_stereo(_blank(), _blank(), world.timestamps[-1] + 0.1 * (f + 1))
        fed.append(-1)
    s.tracker.flush()
    out["state_after_blackout"] = s.tracking_state
    relocalized = False
    for f in range(N_GOOD - 6, world.num_frames):
        s.track_stereo(*world.stereo_pair(f), world.timestamps[f])
        fed.append(f)
        if s.tracking_state == TrackingState.OK:
            relocalized = True
            break
    s.tracker.flush()
    out.update(relocalized=relocalized, fed=fed, resets=s.n_resets)
    out["path"] = str(tmp_path_factory.mktemp("port_ckpt") / "map.npz")
    s.save_map(out["path"])
    out["sys"] = s
    return out


def test_port_resumes_a_map_saved_by_the_reference(port_run, world):
    assert port_run["state_after_load"] == TrackingState.LOST
    assert port_run["relocalizer"]
    n_saved = port_run["n_saved"]
    assert n_saved == N_GOOD + N_BLANK
    res = port_run["resume"]
    assert res["relocalized"], "never relocalized against the loaded map"
    # the resumed trajectory keeps the frame numbering
    assert res["last_frame_id"] == n_saved + len(RESUMED) - 1
    assert res["n_poses"] == n_saved + len(RESUMED)
    # the resumed frames sit where the world says (the reference test's 0.3 m bar)
    for r, f in zip(res["records"], RESUMED):
        if not r.lost:
            assert np.linalg.norm(_centre(r.pose) - _centre(world.poses[f])) < 0.3


def test_localization_mode_freezes_map(port_run):
    loc = port_run["localization"]
    assert loc["resets"] == 0
    assert loc["kfs_after"] == loc["kfs_before"]
    assert loc["state"] == TrackingState.OK


def test_recovers_after_blackout(port_run, world):
    s = port_run["sys"]
    assert s.tracker.relocalizer is not None
    assert port_run["state_after_blackout"] == TrackingState.LOST
    assert port_run["relocalized"], "never relocalized after blackout"
    assert port_run["resets"] == 0
    # one relocalization after the load, one after the blackout
    assert sum(1 for e in s.tracker.metrics.records if e.get("relocalized")) >= 2
    rec = [r for r in s.tracker.records if not r.lost][-1]
    wf = port_run["fed"][rec.frame_id]
    assert wf >= 0
    assert np.linalg.norm(_centre(rec.pose) - _centre(world.poses[wf])) < 0.3


def test_resets_on_early_loss():
    """Lost on a young map (<= 5 keyframes) -> full reset, even with a
    relocalizer present (tracker.cpp:613-620); then it re-initializes."""
    s = TSlamSystem(_tcfg(), device="cpu")
    assert s.tracker.relocalizer is not None
    w = synthetic.make_world(num_frames=8, cam=_jcfg().camera, seed=2, speed=0.8, num_landmarks=2500)
    for f in range(4):
        s.track_stereo(*w.stereo_pair(f), w.timestamps[f])
    for f in range(8):
        s.track_stereo(_blank(), _blank(), 1.0 + 0.1 * f)
    assert s.n_resets >= 1
    for f in range(4):
        s.track_stereo(*w.stereo_pair(f), w.timestamps[f])
    s.tracker.flush()
    assert s.tracking_state in (TrackingState.OK, TrackingState.NOT_INITIALIZED)


def test_reference_reads_a_map_saved_by_the_port(port_run):
    src = port_run["sys"]
    arena, records, vocab = jckpt.load_map(port_run["path"])
    for f in dataclasses.fields(src.arena):
        v = getattr(src.arena, f.name)
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(getattr(arena, f.name), v, err_msg=f.name)
    assert (arena.num_kfs, arena.num_pts, arena.next_point_id) == (
        src.arena.num_kfs, src.arena.num_pts, src.arena.next_point_id)
    assert dataclasses.asdict(arena.cap) == dataclasses.asdict(src.arena.cap)
    assert len(records) == len(src.tracker.records)
    for a, b in zip(records, src.tracker.records):
        assert (a.frame_id, a.lost, a.ref_kf) == (b.frame_id, b.lost, b.ref_kf)
        if b.pose is not None:
            np.testing.assert_allclose(a.pose, b.pose)
    np.testing.assert_array_equal(vocab.node_desc, src.vocab.node_desc)
    np.testing.assert_array_equal(vocab.node_word, src.vocab.node_word)
    # and the port reads its own file back
    arena2, records2, vocab2 = tckpt.load_map(port_run["path"])
    np.testing.assert_array_equal(arena2.kf_pose, src.arena.kf_pose)
    assert len(records2) == len(records) and vocab2.num_words == src.vocab.num_words


def test_checkpoint_format_guard(tmp_path):
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, format_version=np.int64(tckpt.FORMAT_VERSION + 1))
    with pytest.raises(ValueError):
        tckpt.load_map(bad)
    assert tckpt.FORMAT_VERSION == jckpt.FORMAT_VERSION


def test_relocalizer_resolves_its_device_like_the_tracker(ref, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tc, _ = _port_relocalizer(ref["sys"])
    with pytest.raises(RuntimeError):
        treloc.Relocalizer(_tcfg(), tc.arena, _K(), tc)


@pytest.mark.slow
def test_loop_closes_after_relocalization():
    """The port alone on tests/test_system.py's blackout-mid-lap scenario (300
    frames at 640x240, frames 110-112 blank, sync_every=2) with its assertions:
    tracking is lost, relocalizes before the revisit without a reset, and the
    loop still closes at the revisit. Run by hand:
    python -m pytest tests/test_torch_relocalization.py -m slow -s"""
    cfg = _tcfg()
    cfg = dataclasses.replace(cfg, capacity=dataclasses.replace(cfg.capacity, max_keyframes=128))
    n_frames = 300
    world = synthetic.make_world(num_frames=n_frames, cam=_jcfg().camera, seed=4, speed=1.0,
                                 yaw_rate=2.0 * np.pi / 200.0, num_landmarks=2500, corridor_half_width=7.0)
    s = TSlamSystem(cfg, sync_every=2, device="cpu")
    blackout = range(110, 113)
    for f in range(n_frames):
        pair = (_blank(), _blank()) if f in blackout else world.stereo_pair(f)
        s.track_stereo(*pair, world.timestamps[f])
    stats = s.shutdown()
    records = s.tracker.records
    lost_ids = [r.frame_id for r in records if r.lost]
    print(f"lost {lost_ids}, stats {stats}")
    assert len(lost_ids) >= 3, "blackout should lose tracking"
    resumed = [r.frame_id for r in records if not r.lost and r.frame_id > 118]
    assert resumed, "never relocalized after the blackout"
    assert s.n_resets == 0, "must relocalize, not reset (map was mature)"
    assert stats["loops_closed"] >= 1, f"no loop closed after reloc: {stats}"
    tracked = [i for i, r in enumerate(records) if not r.lost]
    est = s.frame_poses()[tracked]
    gt = world.poses[[records[i].frame_id for i in tracked]]
    ate = trajectory.ate_rmse(est, gt, align="se3")
    print(f"ATE over tracked frames {ate:.4f} m")
    assert ate < 1.0, f"post-closure ATE {ate:.3f} m"
