"""The port's distributed layer (slam_framework_torch/parallel/) against the
reference's (slam_framework_tpu/parallel/), the reference on its 8-device CPU
mesh (tests/conftest.py), the port on a `LocalMesh` of CPU threads.

Compared, on the same seeded inputs:
  - `LocalMesh`: the sum is taken in rank order and every rank gets the same
    bits; `all_to_all` is a transpose of the bucket axes; a rank that raises
    hands its exception to the caller, and a rank that never reaches a
    collective times out, instead of hanging the others;
  - the shard layouts (`point_layout`, both `shard_problem`s: the round-robin
    and the owner-keyed deal, an edge count that does not divide) and
    `partition_arena`: exactly equal, array for array; pose-graph pads carry
    identity rotations;
  - `optimize_global_sharded` on the 8-camera scene of tests/test_dist_ba.py
    (2 + 3 LM iterations of 25 CG, the reference demo's: each rank of a thread
    mesh repeats the camera-sized work, so the CPU run keeps them few; the
    card's phase 13 runs the loop closer's 10), the port fed the reference's
    sharded problem through `interop`: camera
    centres within 1e-3 m and points within 2e-3 m of the reference's (the
    order of the camera sums differs: stacked ranks here, psum there), the
    replicated cameras bit-equal on all 8 ranks;
  - `dist_pose_graph.optimize_sharded` on the 24-vertex graph of
    tests/test_dist_pose_graph.py, 4 ranks and 8 GN iterations in both: t within 1e-3, R and s
    within 1e-4 (the tolerances of that test), every rank bit-equal;
  - `run_global_ba_map_sharded` (owner-keyed) and `run_global_ba_dist`
    (round-robin) on the arena of tests/test_map_shard.py, 4 ranks in both:
    the same stats, the written-back poses and points within the BA
    tolerances above;
  - `migrate_points`: bit-equal, the overflow case included;
  - the loop closer's sharded global BA on one copied map, 4 ranks in both:
    dispatch, a keyframe added before the merge (so points change owner),
    merge and migration (3 LM iterations): poses and points within the BA tolerances, the same
    `devices`, `moved` (> 0) and `migrated_ok`.
The sharded program on one rank is the single-device program bit for bit (the
same sum order); a mesh of one rank in the loop closer takes the single-device
path, and a mesh on another device than the system's raises. The `slow` case is the reference's
TestDistributedSystem through the port's SlamSystem on an 8-rank mesh.
"""

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from slam_framework_tpu.parallel import dist_ba as jdba
from slam_framework_tpu.parallel import dist_pose_graph as jdpg
from slam_framework_tpu.parallel import map_shard as jms
from slam_framework_tpu.pipeline.loop_closer import LoopCloser as JLoopCloser
from slam_framework_torch import config as tconf, interop
from slam_framework_torch.geometry.projection import Intrinsics as TIntrinsics
from slam_framework_torch.io import synthetic, trajectory
from slam_framework_torch.optim import global_ba as tgba
from slam_framework_torch.optim import pose_graph as tpg
from slam_framework_torch.parallel import LocalMesh
from slam_framework_torch.parallel import dist_ba as tdba
from slam_framework_torch.parallel import dist_pose_graph as tdpg
from slam_framework_torch.parallel import map_shard as tms
from slam_framework_torch.pipeline.loop_closer import LoopCloser as TLoopCloser
from slam_framework_torch.system import SlamSystem
from test_global_ba import K as JK, _build_problem, _make_scene
from test_loop_closer import _build_two_lap_arena
from test_map_shard import _build_arena
from test_pose_graph import _build_problem as _build_pg_problem

CAM_TOL_M, PT_TOL_M = 1e-3, 2e-3
# the LM / CG iterations of the reference's multi-process demo (tools/multihost_demo.py):
# every rank of a LocalMesh runs the camera-sized work again, so a CPU test keeps them few
ITERS = dict(iters_first=2, iters_second=3, cg_iters=25)
TK = TIntrinsics(*JK)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; torch's default of one
    thread per core in each of them oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _alongside(reference, port):
    """(reference(), port()): the reference runs in a thread (its compile is
    mostly outside the interpreter lock) while the port runs here."""
    with ThreadPoolExecutor(1) as pool:
        want = pool.submit(reference)
        got = port()
        return want.result(), got


def _jmesh(devices, n, axis):
    return Mesh(np.array(devices[:n]), (axis,))


def _centres(poses):
    poses = np.asarray(poses, np.float64)
    return -np.einsum("cji,cj->ci", poses[:, :3, :3], poses[:, :3, 3])


def _port_cfg(jcfg):
    return tconf.SlamConfig(camera=tconf.CameraConfig(**dataclasses.asdict(jcfg.camera)),
                            capacity=tconf.CapacityConfig(**dataclasses.asdict(jcfg.capacity)),
                            loop=tconf.LoopConfig(**dataclasses.asdict(jcfg.loop)))


# ------------------------------------------------------------------ the mesh


def test_all_reduce_sums_in_rank_order_with_the_same_bits_on_every_rank():
    mesh = LocalMesh(8, "cpu")
    rng = np.random.default_rng(0)
    parts = [torch.from_numpy((rng.normal(size=(5, 27)) * 10.0 ** rng.integers(-6, 6, (5, 27))).astype(np.float32))
             for _ in range(8)]
    scalars = [torch.tensor(float(rng.normal()) * 1e3, dtype=torch.float32) for _ in range(8)]
    got = mesh.run(lambda r: (mesh.all_reduce_sum(parts[r]), mesh.all_reduce_sum(scalars[r])))
    want = torch.stack(parts).sum(0)
    for blk, sc in got:
        assert torch.equal(blk, want) and torch.equal(sc, torch.stack(scalars).sum(0)) and sc.dim() == 0


def test_all_to_all_is_a_transpose_and_gather_keeps_rank_order():
    mesh = LocalMesh(4, "cpu")
    sent = [torch.arange(4 * 3 * 2, dtype=torch.float32).reshape(4, 3, 2) + 1000 * s for s in range(4)]
    got = mesh.run(lambda r: mesh.all_to_all(sent[r]))
    for d in range(4):
        assert torch.equal(got[d], torch.stack([sent[s][d] for s in range(4)]))
    assert torch.equal(mesh.gather(got), torch.cat(got))
    x = torch.arange(8.0)
    assert [mesh.block(x, r).tolist() for r in range(4)] == [[0, 1], [2, 3], [4, 5], [6, 7]]


def test_a_failing_rank_reaches_the_caller_and_the_others_do_not_hang():
    mesh = LocalMesh(8, "cpu", timeout=60.0)
    x = torch.ones(3)

    def body(r):
        y = mesh.all_reduce_sum(x)
        if r == 5:
            raise ValueError("rank 5 failed")
        return mesh.all_reduce_sum(y)

    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="rank 5 failed"):
        mesh.run(body)
    assert time.perf_counter() - t0 < 30.0  # the barrier was aborted, not timed out
    assert threading.active_count() < 8 + 2
    # a rank that never reaches the collective: the others time out
    short = LocalMesh(3, "cpu", timeout=0.5)
    with pytest.raises(RuntimeError, match="not reached by every rank"):
        short.run(lambda r: None if r == 0 else short.all_reduce_sum(x))
    # the meshes are usable again, and the ranks keep the caller's grad mode
    assert mesh.run(lambda r: float(mesh.all_reduce_sum(x)[0]))[0] == 8.0
    with torch.no_grad():
        assert mesh.run(lambda r: torch.is_grad_enabled()) == [False] * 8
    with torch.inference_mode():
        assert mesh.run(lambda r: torch.is_inference_mode_enabled()) == [True] * 8
    assert mesh.run(lambda r: torch.is_grad_enabled()) == [True] * 8
    with pytest.raises(RuntimeError, match="different collectives"):
        mesh.run(lambda r: mesh.all_reduce_sum(x) if r else mesh.all_to_all(torch.ones(8, 1)))


# ------------------------------------------------------------------ layouts


@pytest.mark.parametrize("deal", ["round_robin", "owner"])
def test_point_layout_and_shard_problem_equal_the_reference(deal):
    _, poses_init, _, pts_init, obs = _make_scene(n_cams=8, n_pts=100, seed=7)
    prob = _build_problem(poses_init, pts_init, obs, 8, 100)
    n_live = int(np.asarray(prob.pt_mask).sum())
    D, owner = (8, None) if deal == "round_robin" else (4, np.random.default_rng(0).integers(0, 4, n_live))
    for got, want in zip(tdba.point_layout(n_live, D, owner), jdba.point_layout(n_live, D, owner)):
        np.testing.assert_array_equal(got, want)
    want = jdba.shard_problem(prob, D, owner=owner)
    got = tdba.shard_problem(interop.global_ba_problem(prob, "cpu"), D, owner=owner, device="cpu")
    for name in tgba.GlobalBAProblem._fields:
        w = np.asarray(getattr(want, name))
        assert getattr(got, name).numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(getattr(got, name).numpy(), w, err_msg=name)


@pytest.mark.parametrize("n_shards", [8, 7])
def test_pose_graph_shard_problem_equals_the_reference_with_identity_pads(n_shards):
    prob, _, _ = _build_pg_problem(24, drift_rot=0.02, drift_trans=0.08, drift_scale=0.01, seed=3)
    want = jdpg.shard_problem(prob, n_shards)
    got = tdpg.shard_problem(interop.pose_graph_problem(prob, "cpu"), n_shards)
    for name in tpg.PoseGraphProblem._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    live = got.e_mask.numpy()
    assert got.e_i.shape[0] % n_shards == 0
    if n_shards == 7:
        assert (~live).any()
    np.testing.assert_array_equal(got.e_R.numpy()[~live], np.broadcast_to(np.eye(3, dtype=np.float32),
                                                                          ((~live).sum(), 3, 3)))


# ------------------------------------------------------------------ sharded optimizers


def test_optimize_global_sharded_matches_the_reference(cpu_mesh_devices):
    _, poses_init, _, pts_init, obs = _make_scene(n_cams=8, n_pts=100, seed=7)
    prob = _build_problem(poses_init, pts_init, obs, 8, 100)
    jsharded = jdba.shard_problem(prob, 8)
    mesh = LocalMesh(8, "cpu")
    want, per_rank = _alongside(
        lambda: jdba.optimize_global_sharded(jsharded, _jmesh(cpu_mesh_devices, 8, "ba"), JK, **ITERS),
        lambda: tdba.optimize_global_ranks(interop.global_ba_problem(jsharded, "cpu"), mesh, TK, **ITERS))
    assert all(torch.equal(r.cam_pose, per_rank[0].cam_pose) for r in per_rank)
    assert all(torch.equal(r.total_chi2, per_rank[0].total_chi2) for r in per_rank)
    got = tdba.assemble(mesh, per_rank)
    d_cam = np.linalg.norm(_centres(got.cam_pose.numpy()) - _centres(want.cam_pose), axis=1)
    live = np.asarray(jsharded.pt_mask)
    d_pt = np.linalg.norm(got.pt_pos.numpy()[live] - np.asarray(want.pt_pos)[live], axis=1)
    assert d_cam.max() < CAM_TOL_M and d_pt.max() < PT_TOL_M, (d_cam.max(), d_pt.max())
    assert float(got.total_chi2) == pytest.approx(float(want.total_chi2), rel=0.01, abs=1e-3)
    # the same optimum as the port's single-device optimizer
    single = tgba.optimize_global(interop.global_ba_problem(prob, "cpu"), TK, **ITERS)
    assert np.linalg.norm(_centres(single.cam_pose.numpy()) - _centres(got.cam_pose.numpy()), axis=1).max() < CAM_TOL_M


def test_dist_pose_graph_matches_the_reference(cpu_mesh_devices):
    prob, _, _ = _build_pg_problem(24, drift_rot=0.02, drift_trans=0.08, drift_scale=0.01, seed=3)
    mesh = LocalMesh(4, "cpu")
    want, per_rank = _alongside(
        lambda: jdpg.optimize_sharded(jdpg.shard_problem(prob, 4), _jmesh(cpu_mesh_devices, 4, "pg"),
                                      iters=8, cg_iters=30),
        lambda: tdpg.optimize_ranks(tdpg.shard_problem(interop.pose_graph_problem(prob, "cpu"), 4), mesh,
                                    iters=8, cg_iters=30))
    assert all(torch.equal(a, b) for r in per_rank for a, b in zip(r, per_rank[0]))
    got = per_rank[0]
    assert np.allclose(got.v_t.numpy(), np.asarray(want.v_t), atol=1e-3)
    assert np.allclose(got.v_R.numpy(), np.asarray(want.v_R), atol=1e-4)
    assert np.allclose(got.v_s.numpy(), np.asarray(want.v_s), atol=1e-4)
    assert float(got.final_cost) < 1e-3 * float(got.initial_cost)


def test_partition_and_map_sharded_ba_match_the_reference(cpu_mesh_devices):
    jarena, jcfg, poses_gt = _build_arena()
    tarena = interop.arena(jarena)
    for n in (8, 4, 3):
        want, got = jms.partition_arena(jarena, n), tms.partition_arena(tarena, n)
        for f in dataclasses.fields(tms.MapPartition):
            np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name), err_msg=f.name)
        assert got.stats() == want.stats()
    iters = (ITERS["iters_first"], ITERS["iters_second"])
    jstats, tstats = _alongside(
        lambda: jms.run_global_ba_map_sharded(jarena, jcfg, JK, _jmesh(cpu_mesh_devices, 4, "host"), iters=iters),
        lambda: tms.run_global_ba_map_sharded(tarena, _port_cfg(jcfg), TK, LocalMesh(4, "cpu"), iters=iters))
    assert tstats["segments"] == 4
    _assert_written_back_as_the_reference(tstats, jstats, tarena, jarena, poses_gt)


def test_run_global_ba_dist_matches_the_reference(cpu_mesh_devices):
    """The round-robin deal end to end: build, shard, solve, write back."""
    jarena, jcfg, poses_gt = _build_arena()
    tarena = interop.arena(jarena)
    iters = (ITERS["iters_first"], ITERS["iters_second"])
    jstats, tstats = _alongside(
        lambda: jdba.run_global_ba_dist(jarena, jcfg, JK, _jmesh(cpu_mesh_devices, 4, "host"), iters=iters),
        lambda: tdba.run_global_ba_dist(tarena, _port_cfg(jcfg), TK, LocalMesh(4, "cpu"), iters=iters))
    _assert_written_back_as_the_reference(tstats, jstats, tarena, jarena, poses_gt)


def _assert_written_back_as_the_reference(tstats, jstats, tarena, jarena, poses_gt):
    """A 4-rank full-map BA's stats, and the poses and points it wrote back,
    against the reference's within the BA tolerances."""
    assert {k: v for k, v in tstats.items() if k != "chi2"} == {k: v for k, v in jstats.items() if k != "chi2"}
    assert tstats["devices"] == 4
    assert tstats["chi2"] == pytest.approx(jstats["chi2"], rel=0.01, abs=1e-3)
    n = tarena.num_kfs
    assert np.linalg.norm(_centres(tarena.kf_pose[:n]) - _centres(jarena.kf_pose[:n]), axis=1).max() < CAM_TOL_M
    live = tarena.pt_valid[: tarena.num_pts]
    d_pt = np.linalg.norm(tarena.pt_pos[: tarena.num_pts] - jarena.pt_pos[: jarena.num_pts], axis=1)[live]
    assert d_pt.max() < PT_TOL_M
    assert np.linalg.norm(tarena.kf_pose[:8, :3, 3] - poses_gt[:8, :3, 3], axis=1).max() < 2e-2


def test_the_sharded_program_on_one_rank_is_the_single_device_program_bit_for_bit():
    """One rank sums in the single-device order (a problem built from an arena is
    point-major, as a one-shard deal is): the same bits, so the sharded program
    adds nothing to the math but the order of its sums."""
    jarena, jcfg, _ = _build_arena()
    prob = tgba.build_global_problem(interop.arena(jarena), _port_cfg(jcfg))[0]
    one = LocalMesh(1, "cpu")
    sharded = tdba.shard_problem(prob, 1, owner=np.zeros(int(prob.pt_mask.sum()), np.int64))
    for name in ("pt_pos", "obs_cam", "obs_pt", "obs_uv", "pt_obs_slots"):
        assert torch.equal(getattr(sharded, name), getattr(prob, name)), name
    got = tdba.optimize_global_sharded(sharded, one, TK, **ITERS)
    want = tgba.optimize_global(prob, TK, **ITERS)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("case", ["random", "overflow"])
def test_migrate_points_bit_equal_to_the_reference(case, cpu_mesh_devices):
    D = 8
    if case == "random":
        R, F = 16, 5
        rng = np.random.default_rng(3)
        rows = rng.normal(size=(D * R, F)).astype(np.float32)
        mask = rng.random(D * R) < 0.7
        owner = rng.integers(0, D, D * R).astype(np.int32)
    else:
        R, F = 4, 3
        rows = np.arange(D * R * F, dtype=np.float32).reshape(D * R, F)
        mask = np.ones(D * R, bool)
        owner = np.zeros(D * R, np.int32)  # everything to rank 0: overflow
    want_rows, want_mask = jms.migrate_points(_jmesh(cpu_mesh_devices, D, "host"), rows, mask, owner)
    got_rows, got_mask = tms.migrate_points(LocalMesh(D, "cpu"), rows, mask, owner)
    np.testing.assert_array_equal(got_mask, want_mask)
    assert got_rows.dtype == np.float32 and got_rows.tobytes() == np.asarray(want_rows).tobytes()
    if case == "overflow":
        assert got_mask[:R].sum() == R and got_mask[R:].sum() == 0


# ------------------------------------------------------------------ the loop closer and the system


def _grow(arena, like_kf: int) -> None:
    """A keyframe seeing what keyframe like_kf sees (in both packages alike):
    the load moves, so segment cuts and point owners move."""
    n = arena.kf_xy.shape[1]
    arena.add_keyframe(arena.kf_pose[like_kf].copy(), arena.num_kfs, float(arena.num_kfs),
                       arena.kf_xy[like_kf].copy(), arena.kf_ur[like_kf].copy(), arena.kf_depth[like_kf].copy(),
                       arena.kf_octave[like_kf].copy(), arena.kf_angle[like_kf].copy(), arena.kf_desc[like_kf].copy(),
                       arena.kf_feat_valid[like_kf].copy(), arena.kf_point_idx[like_kf][:n].copy())


def _two_laps():
    """The two-lap map of tests/test_loop_closer.py (lap 2 drifted), in the reference's arena."""
    rng = np.random.default_rng(5)
    n_lm = 360
    ang = 2 * np.pi * np.arange(n_lm) / n_lm
    r = 13.0 + rng.uniform(-0.5, 0.5, n_lm)
    pts = np.stack([r * np.cos(ang), r * np.sin(ang), rng.uniform(-1.0, 1.0, n_lm)], axis=1).astype(np.float32)
    descs = rng.integers(0, 2**32, (n_lm, 8), dtype=np.uint64).astype(np.uint32)
    jcfg, JK2, jarena, _ = _build_two_lap_arena((pts, descs))
    return jcfg, JK2, jarena


def test_loop_closer_sharded_global_ba_and_migration_match_the_reference(cpu_mesh_devices):
    jcfg, JK2, jarena = _two_laps()
    jcfg = dataclasses.replace(jcfg, loop=dataclasses.replace(jcfg.loop, global_ba_iters=3))
    tarena = interop.arena(jarena)
    jcloser = JLoopCloser(jcfg, jarena, JK2, None, mesh=_jmesh(cpu_mesh_devices, 4, "ba"))
    tcloser = TLoopCloser(_port_cfg(jcfg), tarena, TIntrinsics(*JK2), None, device="cpu", mesh=LocalMesh(4, "cpu"))
    _alongside(jcloser._dispatch_global_ba, lambda: tcloser._dispatch_global_ba(tarena.num_kfs - 1))
    assert tcloser.has_pending_gba() and tcloser._gba_pending["n_shards"] == 4
    np.testing.assert_array_equal(tcloser._gba_pending["owner"], jcloser._gba_pending["owner"])
    for arena in (jarena, tarena):
        _grow(arena, 0)
        _grow(arena, 1)
    assert jcloser.apply_pending_gba() and tcloser.apply_pending_gba()
    jr, tr = jcloser.last_report, tcloser.last_report
    assert tr["gba"]["devices"] == jr["gba"]["devices"] == 4 and tr["gba"]["shard_devices"] == ["cpu"]
    assert (tr["gba"]["cams"], tr["gba"]["points"], tr["gba"]["merged_kfs"]) == \
        (jr["gba"]["cams"], jr["gba"]["points"], jr["gba"]["merged_kfs"])
    assert tr["migration"] == jr["migration"]
    assert tr["migration"]["moved"] > 0 and tr["migration"]["migrated_ok"]
    n = tarena.num_kfs
    assert np.linalg.norm(_centres(tarena.kf_pose[:n]) - _centres(jarena.kf_pose[:n]), axis=1).max() < CAM_TOL_M
    live = tarena.pt_valid[: tarena.num_pts]
    d_pt = np.linalg.norm(tarena.pt_pos[: tarena.num_pts] - jarena.pt_pos[: jarena.num_pts], axis=1)[live]
    assert d_pt.max() < PT_TOL_M
    for f in dataclasses.fields(tms.MapPartition):
        np.testing.assert_array_equal(getattr(tcloser.partition, f.name), getattr(jcloser.partition, f.name))


def test_a_one_rank_mesh_takes_the_single_device_path_and_a_mesh_elsewhere_raises():
    jcfg, JK2, jarena = _two_laps()
    results = []
    for mesh in (None, LocalMesh(1, "cpu")):
        closer = TLoopCloser(_port_cfg(jcfg), interop.arena(jarena), TIntrinsics(*JK2), None, device="cpu", mesh=mesh)
        closer._dispatch_global_ba(0)
        assert "owner" not in closer._gba_pending
        results.append(closer._gba_pending["res"])
        assert closer.apply_pending_gba() and closer.last_report["gba"]["devices"] == 1
        assert "migration" not in closer.last_report
    assert all(torch.equal(a, b) for a, b in zip(*results))
    cfg = _port_cfg(jcfg)
    one = LocalMesh(1, "cpu")
    system = SlamSystem(cfg, device="cpu", mesh=one)
    assert system.loop_closer.mesh is one
    system.reset()  # a rebuilt loop closer gets the mesh again
    assert system.loop_closer.mesh is one
    with pytest.raises(ValueError, match="not on the system's device"):
        SlamSystem(cfg, device="cpu", mesh=LocalMesh(2, "meta"))
    with pytest.raises(ValueError, match="not on the loop closer's device"):
        TLoopCloser(cfg, interop.arena(jarena), TIntrinsics(*JK2), None, device="cpu", mesh=LocalMesh(2, "meta"))


@pytest.mark.slow
def test_system_on_an_eight_rank_mesh_closes_its_loop_and_migrates():
    """The reference's TestDistributedSystem (tests/test_system.py) through the
    port: 270 frames at 640x240, seed 4; the post-loop global BA over
    LocalMesh(8, "cpu"). Run by hand:
    python -m pytest tests/test_torch_dist.py -m slow -s"""
    cfg = tconf.SlamConfig(
        camera=tconf.CameraConfig(fx=400.0, fy=400.0, cx=320.0, cy=120.0, width=640, height=240, fps=10.0,
                                  bf=400.0 * 0.54),
        orb=tconf.OrbConfig(num_features=800, num_levels=4),
        capacity=tconf.CapacityConfig(max_keyframes=64, max_map_points=65536, max_features=1024,
                                      local_window_points=8192),
    )
    n_frames = 270
    world = synthetic.make_world(num_frames=n_frames, cam=cfg.camera, seed=4, speed=1.0,
                                 yaw_rate=2.0 * np.pi / 200.0, num_landmarks=2500, corridor_half_width=7.0)
    system = SlamSystem(cfg, device="cpu", mesh=LocalMesh(8, "cpu"))
    for f in range(n_frames):
        system.track_stereo(*world.stereo_pair(f), world.timestamps[f])
    stats = system.shutdown()
    rep = system.loop_closer.last_report
    print(stats, rep)
    assert stats["loops_closed"] >= 1, stats
    assert rep.get("gba", {}).get("devices", 1) == 8, rep.get("gba")
    mig = rep.get("migration")
    assert mig is not None and mig["migrated_ok"] and mig["segments"] == 8, mig
    assert sum(1 for r in system.tracker.records if r.lost) <= 3
    est = system.frame_poses()
    gt = world.poses[[r.frame_id for r in system.tracker.records]]
    ate = trajectory.ate_rmse(est, gt, align="se3")
    print("ATE", ate)
    assert ate < 1.0
