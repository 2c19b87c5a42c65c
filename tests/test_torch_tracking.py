"""Parity of the port's tracking core and keyframe bookkeeping with the reference
StereoTracker (pipeline/tracker.py, pipeline/track_ops.py).

The reference is initialised on frame 0 of the small world (its mapper's
`note_new_points` stubbed: no keyframe is processed here, so the mapper plays no
part; tests/test_torch_slice.py runs both packages with the mapper on); its
DeviceTrackState, PointBlock and
FrameData then go through `_track_core` in both packages via interop.py.

Tolerances: pose within 1e-4 (fp32 pose optimisation, sums in another order,
see test_torch_pose_opt.py); associations, counts and fusion candidates
identical (integer outcomes of the same gates). Host bookkeeping (block
rebuild, point statistics, remap) is numpy on both sides and must be equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from slam_framework_tpu.config import CameraConfig as JCam, CapacityConfig as JCap, OrbConfig as JOrb
from slam_framework_tpu.config import SlamConfig as JCfg
from slam_framework_tpu.pipeline.local_mapper import LocalMapper
from slam_framework_tpu.pipeline.tracker import StereoTracker as JTracker
from slam_framework_torch import config as tconf, interop
from slam_framework_torch.io import synthetic as tsyn
from slam_framework_torch.pipeline.tracker import StereoTracker as TTracker


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; torch's default of one
    thread per core in each of them oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CAM = dict(fx=400.0, fy=400.0, cx=320.0, cy=120.0, width=640, height=240, fps=10.0, bf=400.0 * 0.54)
CAP = dict(max_keyframes=64, max_map_points=65536, max_features=1024, local_window_points=8192)


@pytest.fixture(scope="module")
def setup():
    jcfg = JCfg(camera=JCam(**CAM), orb=JOrb(num_features=800, num_levels=4), capacity=JCap(**CAP))
    tcfg = tconf.SlamConfig(camera=tconf.CameraConfig(**CAM), orb=tconf.OrbConfig(num_features=800, num_levels=4),
                            capacity=tconf.CapacityConfig(**CAP))
    world = tsyn.make_world(num_frames=30, cam=tcfg.camera, seed=1, speed=0.8, yaw_rate=0.004)
    pairs = [world.stereo_pair(f) for f in range(4)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(LocalMapper, "note_new_points", lambda self, *a, **k: None)
        jt = JTracker(jcfg, sync_every=4)
        jt.track(*pairs[0], world.timestamps[0])
    core = jax.jit(jt._track_core)
    fds = [jt.frontend(jnp.asarray(l), jnp.asarray(r)) for l, r in pairs[1:]]
    # reference states before frames 1, 2, 3 (frame 3 starts with a non-trivial velocity)
    states = [jt._dstate]
    for fd in fds[:-1]:
        states.append(core(states[-1], fd, jt._block)[0])
    return dict(jcfg=jcfg, tcfg=tcfg, world=world, pairs=pairs, jt=jt, core=core, fds=fds, states=states)


@pytest.mark.parametrize("frame", [1, 3])
def test_track_core_matches_reference(setup, frame):
    jt = setup["jt"]
    st, fd = setup["states"][frame - 1], setup["fds"][frame - 1]
    want = jax.device_get(setup["core"](st, fd, jt._block))
    tt = TTracker(setup["tcfg"], device=torch.device("cpu"))
    got = tt._track_core(interop.track_state(jax.device_get(st)), interop.frame_data(jax.device_get(fd)),
                         interop.point_block(jax.device_get(jt._block)))
    (js, jsum, jpack, jdesc, jvis, jfound), (ts, tsum, tpack, tdesc, tvis, tfound) = want, got
    np.testing.assert_allclose(ts.pose.numpy(), js.pose, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ts.velocity.numpy(), js.velocity, atol=1e-4, rtol=0)
    for name in ("assoc_slot", "pt_mask", "octave"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), getattr(js, name))
    np.testing.assert_array_equal(interop.to_numpy(ts.desc, uint32=True), js.desc)
    np.testing.assert_allclose(ts.pt_pos.numpy(), js.pt_pos, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tsum.numpy()[16:], jsum[16:])     # match / inlier / close counts
    np.testing.assert_allclose(tsum.numpy()[:16], jsum[:16], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tpack.numpy()[:, 7:], jpack[:, 7:])  # slot + fusion candidates
    np.testing.assert_array_equal(tvis.numpy(), jvis)
    np.testing.assert_array_equal(tfound.numpy(), jfound)
    assert jsum[17] > 100  # a healthy lock, not a trivially empty comparison


def _port_tracker_on_reference_map(setup):
    jt = setup["jt"]
    tt = TTracker(setup["tcfg"], arena=interop.arena(jt.arena), device=torch.device("cpu"))
    tt.ref_kf = jt.ref_kf
    return tt


def test_rebuild_block_matches_reference(setup):
    jt = setup["jt"]
    tt = _port_tracker_on_reference_map(setup)
    tt._rebuild_block()
    np.testing.assert_array_equal(tt._block_ids, jt._block_ids)
    want = interop.point_block(jax.device_get(jt._block))
    for g, w in zip(tt._block, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_remap_program_matches_reference(setup):
    jt = setup["jt"]
    st = jax.device_get(jt._dstate)
    rng = np.random.default_rng(0)
    P = jt._block.pos.shape[0]
    perm = np.where(rng.random(P) < 0.8, rng.permutation(P), -1).astype(np.int32)
    new_pos = rng.standard_normal((P, 3)).astype(np.float32)
    want = jax.device_get(JTracker._remap_program(st, jnp.asarray(perm), jnp.asarray(new_pos)))
    got = TTracker._remap_program(interop.track_state(st), torch.from_numpy(perm), torch.from_numpy(new_pos))
    for name in ("assoc_slot", "pt_mask", "pt_pos"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name))


def test_point_stats_and_keyframe_decision_match_reference(setup):
    jt = setup["jt"]
    tt = _port_tracker_on_reference_map(setup)
    jarena = interop.arena(jt.arena)  # a copy the reference method may mutate
    jt_copy = JTracker.__new__(JTracker)
    jt_copy.arena, jt_copy.cfg = jarena, jt.cfg
    pids = np.arange(0, jt.arena.num_pts, 3, dtype=np.int32)
    JTracker._update_point_stats(jt_copy, pids)
    tt._update_point_stats(pids)
    for name in ("pt_normal", "pt_min_dist", "pt_max_dist", "pt_desc"):
        np.testing.assert_array_equal(getattr(tt.arena, name), getattr(jarena, name))
    s = np.zeros(24, np.float32)
    for inl, close_t, close_u in [(400, 300, 10), (20, 50, 90), (10, 0, 0), (250, 120, 80)]:
        s[17], s[18], s[19] = inl, close_t, close_u
        for fid in (1, 5, 12):
            tt.last_kf_frame_id = jt.last_kf_frame_id
            assert tt._need_new_keyframe(fid, s) == jt._need_new_keyframe(fid, s)


def test_initialize_matches_reference(setup):
    jt = setup["jt"]
    tt = TTracker(setup["tcfg"], device=torch.device("cpu"))
    l, r = setup["pairs"][0]
    assert tt._initialize(tt._to_pair(l, r), setup["world"].timestamps[0])
    ja, ta = jt.arena, tt.arena
    assert ta.num_kfs == ja.num_kfs == 1
    np.testing.assert_array_equal(ta.kf_xy[0], ja.kf_xy[0])
    np.testing.assert_array_equal(ta.kf_feat_valid[0], ja.kf_feat_valid[0])
    # stereo depth may differ where a fp32-rounding descriptor flip moves one
    # stereo match (see test_torch_frontend.py); the point count follows it
    assert abs(ta.num_pts - ja.num_pts) <= 0.02 * ja.num_pts
    both = (ta.kf_point_idx[0] >= 0) & (ja.kf_point_idx[0] >= 0)
    assert both.sum() >= 0.97 * (ja.kf_point_idx[0] >= 0).sum()
    np.testing.assert_allclose(ta.pt_pos[ta.kf_point_idx[0][both]], ja.pt_pos[ja.kf_point_idx[0][both]],
                               rtol=1e-4, atol=1e-4)
    assert tt._dstate.pose.dtype == torch.float32 and tt._block.pos.shape == (CAP["local_window_points"], 3)
