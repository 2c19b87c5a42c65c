"""The port's loop closer against the reference (pipeline/loop_closer.py) on the
two-lap scenario of tests/test_loop_closer.py: a camera drives the same circle
twice, the second lap's keyframes and landmarks carry a rigid drift. The arena
is built once with the reference's MapArena and copied (`interop.arena`); the
vocabulary is trained once and copied. Both closers then see every keyframe.

Compared: per keyframe the same candidate list out of `_detect` (BoW words,
scores, covisibility voting: integer and host arithmetic, so exactly equal); the
same keyframe at which the loop closes and the same loop keyframe; the
corrected lap-2 camera centres under 0.15 m from the truth in both (the
reference test's bound) and within 2 cm of each other; the global BA in
flight after the closure and merged later, without degrading the correction;
no loop on a single lap. The two packages draw different RANSAC triplets (the
port from a host `torch.Generator`), so the Sim3 is held by its outcome.
"""

import numpy as np
import pytest
import torch

from slam_framework_tpu.bow import vocabulary as jvoc
from slam_framework_tpu.pipeline.loop_closer import LoopCloser as JLoopCloser
from slam_framework_torch import config as tconf, interop
from slam_framework_torch.geometry.projection import Intrinsics as TIntrinsics
from slam_framework_torch.pipeline import loop_closer as tlc
from test_loop_closer import N_LANDMARKS, N_PER_LAP, _build_two_lap_arena, _center_errors


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; torch's default of one
    thread per core in each of them oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _world():
    rng = np.random.default_rng(5)
    ang = 2 * np.pi * np.arange(N_LANDMARKS) / N_LANDMARKS
    r = 13.0 + rng.uniform(-0.5, 0.5, N_LANDMARKS)
    pts = np.stack([r * np.cos(ang), r * np.sin(ang), rng.uniform(-1.0, 1.0, N_LANDMARKS)], axis=1).astype(np.float32)
    descs = rng.integers(0, 2**32, (N_LANDMARKS, 8), dtype=np.uint64).astype(np.uint32)
    return pts, descs


def _port_cfg(jcfg):
    import dataclasses

    return tconf.SlamConfig(camera=tconf.CameraConfig(**dataclasses.asdict(jcfg.camera)),
                            capacity=tconf.CapacityConfig(**dataclasses.asdict(jcfg.capacity)))


def _drive(closer, n_kfs, stop_at_closure=True):
    """Feed keyframes 0..n_kfs-1; record what `_detect` returned for each."""
    detected = {}
    inner = closer._detect

    def recording(kf, bow):
        out = inner(kf, bow)
        detected[kf] = list(out)
        return out

    closer._detect = recording
    closed_at = None
    for k in range(n_kfs):
        if closer.process_keyframe(k):
            closed_at = k
            if stop_at_closure:
                break
    return closed_at, detected


@pytest.fixture(scope="module")
def laps():
    world = _world()
    jcfg, JK, jarena, gt_poses = _build_two_lap_arena(world)
    tarena = interop.arena(jarena)
    jvocab = jvoc.train(world[1], k=6, depth=3, seed=0)
    tvocab = interop.vocabulary(jvocab)
    jcloser = JLoopCloser(jcfg, jarena, JK, jvocab)
    tcloser = tlc.LoopCloser(_port_cfg(jcfg), tarena, TIntrinsics(*JK), tvocab, device="cpu")
    err_before = _center_errors(tarena, gt_poses, np.arange(N_PER_LAP, 2 * N_PER_LAP))
    j_closed, j_detected = _drive(jcloser, jarena.num_kfs)
    t_closed, t_detected = _drive(tcloser, tarena.num_kfs)
    return dict(world=world, jcfg=jcfg, JK=JK, gt=gt_poses, err_before=err_before,
                j=(jcloser, jarena, j_closed, j_detected), t=(tcloser, tarena, t_closed, t_detected))


def test_same_candidates_per_keyframe_and_same_closure(laps):
    jcloser, _, j_closed, j_detected = laps["j"]
    tcloser, _, t_closed, t_detected = laps["t"]
    assert t_detected == j_detected
    assert any(t_detected.values())
    assert t_closed == j_closed and t_closed is not None and t_closed >= N_PER_LAP
    assert tcloser.last_loop_kf == jcloser.last_loop_kf
    assert [(a, b) for a, b, _ in tcloser.loop_edges] == [(a, b) for a, b, _ in jcloser.loop_edges]
    assert tcloser.n_loops_closed == jcloser.n_loops_closed == 1
    assert tcloser.n_sim3_attempts == jcloser.n_sim3_attempts
    # the database holds the same words for the same keyframes
    assert set(tcloser.bow_frames) == set(jcloser.bow_frames)
    for k, bow in tcloser.bow_frames.items():
        np.testing.assert_array_equal(bow.words, jcloser.bow_frames[k].words)
        np.testing.assert_array_equal(bow.values, jcloser.bow_frames[k].values)


def test_report_and_correction_close_to_reference(laps):
    jcloser, jarena, closed_at, _ = laps["j"]
    tcloser, tarena, _, _ = laps["t"]
    jr, tr = jcloser.last_report, tcloser.last_report
    assert tr["candidate"] == jr["candidate"] and tr["group"] == jr["group"]
    assert abs(tr["sim3_inliers"] - jr["sim3_inliers"]) <= 3
    assert abs(tr["guided_matches"] - jr["guided_matches"]) <= 3 and abs(tr["fused"] - jr["fused"]) <= 6
    assert tr["pose_graph"]["cost_after"] <= tr["pose_graph"]["cost_before"]
    lap2 = np.arange(N_PER_LAP, closed_at + 1)
    assert laps["err_before"].max() > 0.5  # the drift is real
    e_t, e_j = _center_errors(tarena, laps["gt"], lap2), _center_errors(jarena, laps["gt"], lap2)
    assert e_t.max() < 0.15 and e_j.max() < 0.15, (e_t, e_j)
    n = tarena.num_kfs
    c_t = -np.einsum("nji,nj->ni", tarena.kf_pose[:n, :3, :3], tarena.kf_pose[:n, :3, 3])
    c_j = -np.einsum("nji,nj->ni", jarena.kf_pose[:n, :3, :3], jarena.kf_pose[:n, :3, 3])
    assert np.linalg.norm(c_t - c_j, axis=1).max() < 0.02
    # map points moved with their keyframes, in both alike
    valid = tarena.pt_valid[: tarena.num_pts]
    np.testing.assert_array_equal(valid, jarena.pt_valid[: jarena.num_pts])
    d = np.linalg.norm(tarena.pt_pos[: tarena.num_pts] - jarena.pt_pos[: jarena.num_pts], axis=1)[valid]
    assert np.median(d) < 0.02 and np.quantile(d, 0.99) < 0.05, (np.median(d), d.max())


def test_async_global_ba_merges_later(laps):
    """Runs after the two tests above: it applies the pending result."""
    jcloser, jarena, closed_at, _ = laps["j"]
    tcloser, tarena, _, _ = laps["t"]
    assert tcloser.has_pending_gba() and jcloser.has_pending_gba(), "the global BA should be in flight"
    assert all(t.device.type == "cpu" for t in tcloser._gba_pending["res"])
    assert tcloser.apply_pending_gba() and jcloser.apply_pending_gba()
    assert not tcloser.has_pending_gba()
    tg, jg = tcloser.last_report["gba"], jcloser.last_report["gba"]
    assert (tg["cams"], tg["points"], tg["merged_kfs"]) == (jg["cams"], jg["points"], jg["merged_kfs"])
    assert np.isfinite(tg["chi2"]) and tg["chi2"] == pytest.approx(jg["chi2"], rel=0.05, abs=1.0)
    lap2 = np.arange(N_PER_LAP, closed_at + 1)
    e_t, e_j = _center_errors(tarena, laps["gt"], lap2), _center_errors(jarena, laps["gt"], lap2)
    assert e_t.max() < 0.15 and e_j.max() < 0.15, (e_t, e_j)
    assert not tcloser.apply_pending_gba()  # a second apply does nothing


def test_no_false_loop_on_single_lap(laps):
    jcfg, JK, jarena, _ = _build_two_lap_arena(laps["world"])
    tcloser = tlc.LoopCloser(_port_cfg(jcfg), interop.arena(jarena), TIntrinsics(*JK),
                             interop.vocabulary(laps["j"][0].vocab), device="cpu")
    for k in range(N_PER_LAP):
        assert not tcloser.process_keyframe(k)
    assert tcloser.n_loops_closed == 0 and tcloser.n_sim3_attempts == 0


def test_device_programs_match_reference(laps):
    """The three matching programs on the same keyframes of the (uncorrected) two-lap arena."""
    import jax.numpy as jnp

    jcfg, JK, jarena, _ = _build_two_lap_arena(laps["world"])
    jcloser = JLoopCloser(jcfg, jarena, JK, laps["j"][0].vocab)
    tcloser = tlc.LoopCloser(_port_cfg(jcfg), interop.arena(jarena), TIntrinsics(*JK), None, device="cpu")
    a, b = N_PER_LAP + 2, 2
    ma = (jarena.kf_point_idx[a] >= 0) & jarena.kf_feat_valid[a]
    mb = (jarena.kf_point_idx[b] >= 0) & jarena.kf_feat_valid[b]
    want = jcloser._match_descriptors(jnp.asarray(jarena.kf_desc[a]), jnp.asarray(ma), jnp.asarray(jarena.kf_desc[b]), jnp.asarray(mb))
    T = interop.to_tensor
    got = tcloser._match_descriptors(T(jarena.kf_desc[a]), T(ma), T(jarena.kf_desc[[b, b + 1]]), T(np.stack([mb, mb])))
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(want[1]))
    assert int(got[1][0].sum()) > 30

    pts, desc, ids = jcloser._local_points_of(b)
    tp, td, tids = tcloser._local_points_of(b)
    np.testing.assert_array_equal(tp, pts)
    np.testing.assert_array_equal(td, desc)
    np.testing.assert_array_equal(tids, ids)
    S = (np.eye(3, dtype=np.float32), np.array([0.05, -0.02, 0.1], np.float32), np.float32(1.0))
    T_b = jarena.kf_pose[b]
    S = (T_b[:3, :3].copy(), T_b[:3, 3] + S[1], S[2])
    jargs = [jnp.asarray(x) for x in S] + [jnp.asarray(pts), jnp.asarray(desc), jnp.asarray(ids >= 0),
                                           jnp.asarray(jarena.kf_xy[b]), jnp.asarray(jarena.kf_desc[b]),
                                           jnp.asarray(jarena.kf_feat_valid[b])]
    want = jcloser._guided_projection_match(*jargs)
    got = tcloser._guided_projection_match(*[T(np.asarray(x)) for x in jargs])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[1].sum()) > 30

    # SearchBySim3 between a lap-2 keyframe and its lap-1 twin through the true relative pose
    def cam_points(k):
        pid = jarena.kf_point_idx[k]
        Tk = jarena.kf_pose[k].astype(np.float64)
        p = jarena.pt_pos[np.maximum(pid, 0)] @ Tk[:3, :3].T + Tk[:3, 3]
        # max distance = the distance itself: predicted level 0, the octave of every feature here
        return p.astype(np.float32), pid >= 0, np.linalg.norm(p, axis=1).astype(np.float32) * 0.99

    pa, mpa, mda = cam_points(a)
    pb, mpb, mdb = cam_points(2)
    gt = laps["gt"]
    T_ab = gt[a].astype(np.float64) @ np.linalg.inv(gt[2].astype(np.float64))  # twin -> current, the truth
    half = np.arange(256) % 2 == 0  # leave half of the features to be found
    jargs = [jnp.asarray(T_ab[:3, :3].astype(np.float32)), jnp.asarray(T_ab[:3, 3].astype(np.float32)), jnp.float32(1.0),
             jnp.asarray(pa), jnp.asarray(mpa & half), jnp.asarray(jarena.kf_desc[a]), jnp.asarray(jarena.kf_xy[a]),
             jnp.asarray(jarena.kf_octave[a].astype(np.int32)), jnp.asarray(mda),
             jnp.asarray(pb), jnp.asarray(mpb), jnp.asarray(jarena.kf_desc[2]), jnp.asarray(jarena.kf_xy[2]),
             jnp.asarray(jarena.kf_octave[2].astype(np.int32)), jnp.asarray(mdb)]
    want = np.asarray(jcloser._search_by_sim3(*jargs))
    got = tcloser._search_by_sim3(*[T(np.asarray(x)) for x in jargs]).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).sum() > 10


def test_loop_closer_resolves_its_device_like_the_tracker(laps, monkeypatch):
    jcfg, JK, jarena, _ = _build_two_lap_arena(laps["world"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlc.LoopCloser(_port_cfg(jcfg), interop.arena(jarena), TIntrinsics(*JK), None)
    closer = tlc.LoopCloser(_port_cfg(jcfg), interop.arena(jarena), TIntrinsics(*JK), None, device="cpu")
    assert closer.device.type == "cpu" and closer.kf_store.device.type == "cpu"
    assert not closer.process_keyframe(0)  # no vocabulary: the stage is off


def test_compute_sim3_recovers_the_scale_of_a_monocular_map(laps, monkeypatch):
    """ComputeSim3 with a free scale (fix_scale=False, the monocular sensor): the
    two-lap arena with lap 2's keyframes and points also scaled by 1.1 about the
    origin, as a monocular map's scale drifts, and no stereo coordinate. Lap 2's
    keyframe 2 against lap 1's keyframe 3, a neighbour of its twin: between twins
    the two cameras coincide, the reprojections do not see the scale, and the
    refinement leaves it where the noise takes it (the reference alone reads
    1.194, 1.115 and 1.103 on three twin pairs). The port is handed the
    reference's RANSAC triplets (PRNGKey(7), split per attempt). Both accept the
    candidate: R within 1e-4, t within 1e-3 m and s within 1e-4 of each other, s
    within 1e-3 of the truth, the same inlier count."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    key = [jax.random.PRNGKey(7)]

    def reference_sets(mask, n_hypotheses, generator, set_size=3):
        key[0], sub = jax.random.split(key[0])
        probs = jnp.asarray(mask.numpy()).astype(jnp.float32)
        probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
        sets = jax.random.choice(sub, len(mask), shape=(n_hypotheses, set_size), replace=True, p=probs)
        return torch.from_numpy(np.asarray(sets).astype(np.int64))

    monkeypatch.setattr(tlc.sim3solver, "sample_index_sets", reference_sets)

    s_true = 1.1
    jcfg, JK, jarena, _ = _build_two_lap_arena(laps["world"])
    jcfg = dataclasses.replace(jcfg, sensor="monocular")
    lap2 = np.arange(N_PER_LAP, 2 * N_PER_LAP)
    pids = np.nonzero(jarena.pt_valid[: jarena.num_pts])[0]
    obs = jarena.pt_obs_kf[pids]
    in_lap2 = ((obs >= N_PER_LAP) | (obs < 0)).all(axis=1)
    jarena.pt_pos[pids[in_lap2]] *= s_true
    jarena.kf_pose[lap2, :3, 3] *= s_true
    jarena.kf_ur[: jarena.num_kfs] = -1.0
    jarena.kf_depth[: jarena.num_kfs] = -1.0
    kf, cand = N_PER_LAP + 2, 3
    jcloser = JLoopCloser(jcfg, jarena, JK, laps["j"][0].vocab)
    tcfg = dataclasses.replace(_port_cfg(jcfg), sensor="monocular")
    tcloser = tlc.LoopCloser(tcfg, interop.arena(jarena), TIntrinsics(*JK), interop.vocabulary(laps["j"][0].vocab),
                             device="cpu")
    assert not tcloser._fix_scale
    want = jcloser._compute_sim3(kf, [cand])
    got = tcloser._compute_sim3(kf, [cand])
    assert want is not None and got is not None and got.kf == want.kf == cand
    np.testing.assert_allclose(got.Scl["R"], np.asarray(want.Scl["R"]), atol=1e-4)
    np.testing.assert_allclose(got.Scl["t"], np.asarray(want.Scl["t"]), atol=1e-3)
    assert abs(got.Scl["s"] - float(want.Scl["s"])) < 1e-4, (got.Scl["s"], want.Scl["s"])
    assert abs(got.Scl["s"] - s_true) < 1e-3 and got.n_inliers == want.n_inliers
