"""Parity of the port's matrix-free global BA with the reference
(optim/global_ba.py) on the four scenes of tests/test_global_ba.py: the same
seeded problem goes through `optimize_global` in both packages.

Tolerances: camera centres within 1e-3 m of the reference's, `total_chi2`
within 1% (1e-3 absolute on the noise-free scenes, whose chi2 is ~0), inlier
masks equal on >= 99% of the observations, fixed cameras bit-unchanged, and the
port's own result inside the bound the reference's test of the scene sets. The
packages take the same LM steps up to fp32 rounding: the port sums a camera's
slots in one pass where the reference sums them in chunks, and inverts the 6x6
blocks by LU without pivot checks. The acceptance test is strict, so the
comparison is by outcome (see tests/test_torch_local_ba.py on the 3x3 blocks
of points left with one view). `build_global_problem` gives the reference's
problem field by field on an arena copied with `interop.arena`, and
`run_global_ba` writes the same poses back.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from slam_framework_tpu.config import CameraConfig as JCam, CapacityConfig as JCap, SlamConfig as JCfg
from slam_framework_tpu.map.arena import MapArena as JArena
from slam_framework_tpu.optim import global_ba as jgba
from slam_framework_torch import config as tconf, interop
from slam_framework_torch.geometry.projection import Intrinsics as TIntrinsics
from slam_framework_torch.optim import global_ba as tgba
from test_global_ba import BF, CX, CY, FX, FY, K as JK, _build_problem, _make_scene


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; torch's default of one
    thread per core in each of them oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TK = TIntrinsics(*JK)
N_CAMS, N_PTS = 24, 400
_reference_optimize = jax.jit(functools.partial(jgba.optimize_global, K=JK))
_cache = {}


def _scene(name):
    if name == "converges_to_ground_truth":
        poses_gt, poses_init, pts, pts_init, obs = _make_scene()
        bad = None
    elif name == "outliers_rejected":
        poses_gt, poses_init, pts, pts_init, obs = _make_scene(seed=1)
        rng = np.random.default_rng(2)
        n_bad = len(obs) // 20
        bad = rng.choice(len(obs), n_bad, replace=False)
        obs[bad, 2:4] += rng.uniform(30, 80, (n_bad, 2)) * rng.choice([-1, 1], (n_bad, 2))
    else:
        poses_gt, poses_init, pts, pts_init, obs = _make_scene(seed=3)
        obs[:, 4] = -1.0  # all mono
        bad = None
    return _build_problem(poses_init, pts_init, obs, N_CAMS, N_PTS), poses_gt, pts, len(obs), bad


def _run(name):
    if name not in _cache:
        prob, poses_gt, pts, m, bad = _scene(name)
        want = _reference_optimize(prob)
        got = tgba.optimize_global(interop.global_ba_problem(prob, "cpu"), TK)
        _cache[name] = (prob, poses_gt, pts, m, bad, want, got)
    return _cache[name]


def _centres(poses):
    poses = np.asarray(poses, np.float64)
    return -np.einsum("cji,cj->ci", poses[:, :3, :3], poses[:, :3, 3])


SCENES = ["converges_to_ground_truth", "outliers_rejected", "mono_observations"]


@pytest.mark.parametrize("name", SCENES)
def test_camera_centres_and_chi2_match_reference(name):
    prob, poses_gt, pts, m, bad, want, got = _run(name)
    d = np.linalg.norm(_centres(got.cam_pose.numpy()) - _centres(want.cam_pose), axis=1)
    assert d.max() < 1e-3, d
    assert float(got.total_chi2) == pytest.approx(float(want.total_chi2), rel=0.01, abs=1e-3)
    err = np.linalg.norm(got.cam_pose.numpy()[:N_CAMS, :3, 3] - poses_gt[:, :3, 3], axis=1)
    assert err.max() < (5e-3 if name == "converges_to_ground_truth" else 2e-2), err
    if name == "converges_to_ground_truth":
        assert np.median(np.linalg.norm(got.pt_pos.numpy()[:N_PTS] - pts, axis=1)) < 5e-3
    pd = np.linalg.norm(got.pt_pos.numpy() - np.asarray(want.pt_pos), axis=1)[:N_PTS]
    assert np.median(pd) < 1e-3, np.median(pd)


@pytest.mark.parametrize("name", SCENES)
def test_inlier_masks_match_and_fixed_cameras_unchanged(name):
    prob, _, _, m, bad, want, got = _run(name)
    mask = np.asarray(prob.obs_mask)
    assert (got.obs_inlier.numpy() == np.asarray(want.obs_inlier))[mask].mean() >= 0.99
    assert not got.obs_inlier.numpy()[~mask].any()
    fixed = np.asarray(prob.cam_fixed)
    np.testing.assert_array_equal(got.cam_pose.numpy()[fixed], np.asarray(prob.cam_pose)[fixed])
    if bad is not None:
        assert got.obs_inlier.numpy()[:m][bad].mean() < 0.2


def _arena_scene():
    """The tiny arena of the reference's round-trip test, built once in the reference's MapArena."""
    poses_gt, poses_init, pts, pts_init, obs = _make_scene(n_cams=8, n_pts=120, seed=4)
    cam = dict(fx=FX, fy=FY, cx=CX, cy=CY, width=320, height=240, bf=BF)
    cap = dict(max_keyframes=16, max_map_points=512, max_features=256)
    jcfg = JCfg(camera=JCam(**cam), capacity=JCap(**cap))
    tcfg = tconf.SlamConfig(camera=tconf.CameraConfig(**cam), capacity=tconf.CapacityConfig(**cap))
    arena = JArena.create(jcfg.capacity, 256)
    pid_of = {}
    descs = np.random.default_rng(0).integers(0, 2**32, (120, 8), dtype=np.uint64).astype(np.uint32)
    by_cam = {}
    for (c, p, u, v, ur) in obs:
        by_cam.setdefault(int(c), []).append((int(p), u, v, ur))
    for c in range(8):
        xy = np.zeros((256, 2), np.float32)
        urr = np.full(256, -1.0, np.float32)
        desc = np.zeros((256, 8), np.uint32)
        valid = np.zeros(256, bool)
        point_idx = np.full(256, -1, np.int32)
        for f, (p, u, v, ur) in enumerate(by_cam[c][:256]):
            xy[f], urr[f], desc[f], valid[f] = (u, v), ur, descs[p], True
            if p not in pid_of:
                pid_of[p] = arena.add_point(pts_init[p], descs[p], c, np.array([0, 0, 1.0], np.float32), 0.5, 40.0)
            point_idx[f] = pid_of[p]
        arena.add_keyframe(poses_init[c], c, float(c), xy, urr, np.full(256, -1.0, np.float32),
                           np.zeros(256, np.int16), (np.arange(256) % 8).astype(np.float32) * 0, desc, valid, point_idx)
    arena.kf_octave[:8] = (np.arange(256) % 4).astype(np.int16)  # several sigma levels
    return jcfg, tcfg, arena, poses_gt


def test_build_global_problem_equal_field_by_field_and_arena_roundtrip():
    jcfg, tcfg, jarena, poses_gt = _arena_scene()
    tarena = interop.arena(jarena)
    jprob, jcams, jpids = jgba.build_global_problem(jarena, jcfg)
    tprob, tcams, tpids = tgba.build_global_problem(tarena, tcfg, device="cpu")
    np.testing.assert_array_equal(tcams, jcams)
    np.testing.assert_array_equal(tpids, jpids)
    for name in tgba.GlobalBAProblem._fields:
        g, w = getattr(tprob, name), np.asarray(getattr(jprob, name))
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    # a fixed set chosen by the caller, and the cap on observations per point
    jprob2 = jgba.build_global_problem(jarena, jcfg, fix_kfs=[2, 5], max_obs_per_point=4)[0]
    tprob2 = tgba.build_global_problem(tarena, tcfg, fix_kfs=[2, 5], max_obs_per_point=4, device="cpu")[0]
    for name in tgba.GlobalBAProblem._fields:
        np.testing.assert_array_equal(getattr(tprob2, name).numpy(), np.asarray(getattr(jprob2, name)), err_msg=name)

    jstats = jgba.run_global_ba(jarena, jcfg, JK)
    tstats = tgba.run_global_ba(tarena, tcfg, TK, device="cpu")
    assert (tstats["cams"], tstats["points"], tstats["obs"]) == (jstats["cams"], jstats["points"], jstats["obs"]) \
        and tstats["cams"] == 8
    assert tstats["chi2"] == pytest.approx(jstats["chi2"], rel=0.01, abs=1e-3)
    assert np.linalg.norm(_centres(tarena.kf_pose[:8]) - _centres(jarena.kf_pose[:8]), axis=1).max() < 1e-3
    assert np.linalg.norm(tarena.kf_pose[:8, :3, 3] - poses_gt[:8, :3, 3], axis=1).max() < 2e-2
    np.testing.assert_array_equal(tarena.kf_pose[0], jarena.kf_pose[0])  # the fixed first keyframe


def test_two_runs_bit_equal():
    prob = interop.global_ba_problem(_scene("converges_to_ground_truth")[0], "cpu")
    a = tgba.optimize_global(prob, TK, iters_first=0, iters_second=3)
    b = tgba.optimize_global(prob, TK, iters_first=0, iters_second=3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
