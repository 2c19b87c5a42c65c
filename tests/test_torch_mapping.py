"""Parity of the port's mapping programs and LocalMapper host logic with the
reference (matching/*.py batched, pipeline/mapping_ops.py, pipeline/kf_store.py,
pipeline/local_mapper.py), on the synthetic scene of tests/test_local_mapping.py
(64 points with exact projections in keyframes along a line).

Tolerances:
  - batched matcher functions against a loop of the 2-D ones: none (exact);
  - `triangulate_with_neighbors` + `compact_first_match` and
    `fuse_points_into_kfs`: the same (ni, nf) pairs / the same `assoc` on all but
    <= 0.5% of the features, points within 1 cm (measured: identical pairs,
    points within 1e-4 m; the DLT sums differ in order);
  - LocalMapper host logic (numpy on both sides) on an arena copied with
    `interop.arena`, fed the same device results: arenas equal field by field;
    where each package computes its own BA on the device, poses and points
    within 1e-3 m.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_framework_tpu import config as jconf
from slam_framework_tpu.geometry.projection import Intrinsics as JIntrinsics
from slam_framework_tpu.map.arena import MapArena as JArena
from slam_framework_tpu.pipeline import mapping_ops as jmap
from slam_framework_tpu.pipeline.local_mapper import LocalMapper as JMapper
from slam_framework_torch import config as tconf, interop
from slam_framework_torch.geometry.projection import Intrinsics as TIntrinsics
from slam_framework_torch.matching import hamming as tham, matcher as tm
from slam_framework_torch.pipeline import mapping_ops as tmap, track_ops as ttrack
from slam_framework_torch.pipeline.local_mapper import LocalMapper as TMapper, mapper_device


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; torch's default of one
    thread per core in each of them oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


FX = FY = 300.0
CX, CY = 160.0, 120.0
KVALS = dict(fx=FX, fy=FY, cx=CX, cy=CY, bf=60.0)
JK, TK = JIntrinsics(**KVALS), TIntrinsics(**KVALS)
N = 128
CAM = dict(fx=FX, fy=FY, cx=CX, cy=CY, width=320, height=240, bf=60.0)
CAP = dict(max_keyframes=8, max_map_points=512, max_features=N, ba_cams=16, ba_points=256, ba_obs=1024)


def _scene(seed=0):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, 64), rng.uniform(-2, 2, 64), rng.uniform(6, 14, 64)], 1).astype(np.float32)
    descs = rng.integers(0, 2**32, (64, 8), dtype=np.uint64).astype(np.uint32)
    return pts, descs


def _pose(tx):
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = -tx  # camera at x=tx looking down +z
    return T


def _project(T, pts):
    pc = pts @ T[:3, :3].T + T[:3, 3]
    return np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], 1).astype(np.float32)


def _block_arrays(T, pts, descs, n_cand=64):
    pad = N - len(pts)
    return dict(
        pose=T, xy=np.pad(_project(T, pts), ((0, pad), (0, 0))), ur=np.full(N, -1.0, np.float32),
        octave=np.zeros(N, np.int32), angle=np.zeros(N, np.float32),
        desc=np.pad(descs, ((0, pad), (0, 0))), cand=np.arange(N) < n_cand,
    )


def _stack(blocks):
    return {k: np.stack([b[k] for b in blocks]) for k in blocks[0]}


def _jblock(a):
    return jmap.KFBlock(**{k: jnp.asarray(v) for k, v in a.items()})


def _tblock(a):
    return interop.kf_block(type("B", (), a))


# ------------------------------------------------------------------ batched matchers


def _batched_inputs(seed=3, B=4, n=60, m=70):
    rng = np.random.default_rng(seed)
    da = rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    db = rng.integers(0, 2**32, (B, m, 8), dtype=np.uint64).astype(np.uint32)
    db[:, :30] = da[None, :30] ^ (rng.integers(0, 2**32, (B, 30, 8), dtype=np.uint64).astype(np.uint32) & 0x11)
    ham = tham.hamming_matrix(interop.to_tensor(da), interop.to_tensor(db))
    gate = torch.from_numpy(rng.random((B, n, m)) < 0.6)
    valid = rng.random((B, n)) < 0.7
    res = tm.MatchResult(
        idx=torch.from_numpy(np.where(valid, rng.integers(0, m, (B, n)), -1).astype(np.int32)),
        dist=torch.from_numpy(np.where(valid, rng.integers(0, 9, (B, n)), tm.BIG).astype(np.int32)),
        valid=torch.from_numpy(valid),
    )
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    return dict(
        da=interop.to_tensor(da), db=interop.to_tensor(db), ham=ham, gate=gate, res=res, m=m, n=n,
        angle_a=t(rng.uniform(-np.pi, np.pi, n)), angle_b=t(rng.uniform(-np.pi, np.pi, (B, m))),
        pred=t(rng.uniform(0, 320, (B, n, 2))), feat=t(rng.uniform(0, 320, (B, m, 2))),
        radius=t(rng.uniform(5, 60, (B, n))),
        po=torch.from_numpy(rng.integers(0, 8, (B, n)).astype(np.int32)),
        fo=torch.from_numpy(rng.integers(0, 8, (B, m)).astype(np.int32)),
    )


def _res_at(res, b):
    return tm.MatchResult(*[f[b] for f in res])


_BATCHED = {
    "hamming_matrix": lambda d: (tham.hamming_matrix(d["da"], d["db"]),
                                 lambda b: tham.hamming_matrix(d["da"], d["db"][b])),
    "gated_match": lambda d: (tm.gated_match(d["ham"], d["gate"], max_dist=120, nn_ratio=0.95, mutual=True),
                              lambda b: tm.gated_match(d["ham"][b], d["gate"][b], max_dist=120, nn_ratio=0.95,
                                                       mutual=True)),
    "resolve_duplicate_columns": lambda d: (tm.resolve_duplicate_columns(d["res"], d["m"]),
                                            lambda b: tm.resolve_duplicate_columns(_res_at(d["res"], b), d["m"])),
    "rotation_consistency": lambda d: (tm.rotation_consistency(d["angle_a"], d["angle_b"], d["res"]),
                                       lambda b: tm.rotation_consistency(d["angle_a"], d["angle_b"][b],
                                                                         _res_at(d["res"], b))),
    "window_gate": lambda d: (tm.window_gate(d["pred"], d["feat"], d["radius"]),
                              lambda b: tm.window_gate(d["pred"][b], d["feat"][b], d["radius"][b])),
    "octave_gate": lambda d: (tm.octave_gate(d["po"], d["fo"]), lambda b: tm.octave_gate(d["po"][b], d["fo"][b])),
    "invert_matches": lambda d: (ttrack._invert_matches(d["res"], d["n"], d["m"]),
                                 lambda b: ttrack._invert_matches(_res_at(d["res"], b), d["n"], d["m"])),
}


@pytest.mark.parametrize("name", _BATCHED)
def test_batched_matcher_equals_loop_of_2d(name):
    batched, one = _BATCHED[name](_batched_inputs())
    for b in range(4):
        got = batched[b] if isinstance(batched, torch.Tensor) else _res_at(batched, b)
        want = one(b)
        for g, w in zip(*[(x,) if isinstance(x, torch.Tensor) else tuple(x) for x in (got, want)]):
            assert g.shape == w.shape and torch.equal(g, w)
    if name == "gated_match":
        assert int(batched.valid.sum()) > 20  # not a trivially empty comparison


# ------------------------------------------------------------------ device programs


@pytest.fixture(scope="module")
def tri_runs():
    pts, descs = _scene()
    cur = _block_arrays(_pose(0.0), pts, descs)
    # three neighbours; the second is too close (baseline gate), the third sees half the features as free
    nbrs = _stack([_block_arrays(_pose(1.0), pts, descs), _block_arrays(_pose(0.005), pts, descs),
                   _block_arrays(_pose(-0.8), pts, descs, n_cand=32)])
    want = jmap.triangulate_with_neighbors(_jblock(cur), _jblock(nbrs), jnp.float32(0.1), K=JK, num_levels=4,
                                           scale_factor=1.2)
    got = tmap.triangulate_with_neighbors(_tblock(cur), _tblock(nbrs), 0.1, K=TK, num_levels=4, scale_factor=1.2)
    return pts, want, got


def test_triangulate_with_neighbors_matches_reference(tri_runs):
    pts, want, got = tri_runs
    wv, gv = np.asarray(want.valid), got.valid.numpy()
    assert (wv != gv).sum() <= 0.005 * wv.size
    both = wv & gv
    assert both[0, :64].sum() > 50 and both[1].sum() == 0 and 20 < both[2].sum() <= 32
    assert ((np.asarray(want.idx) != got.idx.numpy()) & both).sum() <= 0.005 * wv.size
    assert np.abs(got.pts.numpy() - np.asarray(want.pts))[both].max() < 0.01
    err = np.linalg.norm(got.pts.numpy()[0, :64][both[0, :64]] - pts[both[0, :64]], axis=1)
    assert err.max() < 0.05


def test_compact_first_match_matches_reference(tri_runs):
    _, want, got = tri_runs
    wc, gc = jmap.compact_first_match(want), tmap.compact_first_match(got)
    wv, gv = np.asarray(wc.valid), gc.valid.numpy()
    same_pair = (wv == gv) & (~wv | ((np.asarray(wc.ni) == gc.ni.numpy()) & (np.asarray(wc.nf) == gc.nf.numpy())))
    assert (~same_pair).sum() <= 0.005 * N
    assert np.abs(gc.pts.numpy() - np.asarray(wc.pts))[wv & gv].max() < 0.01
    assert gc.ni.dtype == torch.int32 and set(gc.ni.numpy()[gv]) == {0}  # neighbour 0 matches first wherever any does
    # fed the SAME result, the compaction is exact (first True along the neighbour axis)
    same = tmap.compact_first_match(tmap.TriangulationResult(*[interop.to_tensor(np.asarray(a)) for a in want]))
    for g, w in zip(same, wc):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_compact_first_match_takes_the_first_of_several_neighbours():
    rng = np.random.default_rng(5)
    valid = rng.random((6, 200)) < 0.3
    idx = rng.integers(0, 200, (6, 200)).astype(np.int32)
    pts = rng.standard_normal((6, 200, 3)).astype(np.float32)
    want = jmap.compact_first_match(jmap.TriangulationResult(jnp.asarray(idx), jnp.asarray(pts), jnp.asarray(valid)))
    got = tmap.compact_first_match(tmap.TriangulationResult(*map(torch.from_numpy, (idx, pts, valid))))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (~valid.any(0)).sum() > 5 and (valid.sum(0) > 1).sum() > 50


def test_fuse_points_into_kfs_matches_reference():
    pts, descs = _scene()
    dist = np.linalg.norm(pts, axis=1).astype(np.float32)
    P = N
    pad = P - 64
    point_args = (
        np.pad(pts, ((0, pad), (0, 0))), np.pad(descs, ((0, pad), (0, 0))),
        np.pad(pts / dist[:, None], ((0, pad), (0, 0))), np.pad(0.5 * dist, (0, pad)), np.pad(dist, (0, pad)),
        np.arange(P) < 64,
    )
    kfs = _stack([_block_arrays(_pose(0.5), pts, descs), _block_arrays(_pose(-0.4), pts, descs, n_cand=40)])
    want = np.asarray(jmap.fuse_points_into_kfs(*[jnp.asarray(a) for a in point_args], _jblock(kfs), K=JK,
                                                num_levels=4, scale_factor=1.2, image_wh=(320, 240)))
    got = tmap.fuse_points_into_kfs(*[interop.to_tensor(a) for a in point_args], _tblock(kfs), K=TK,
                                    num_levels=4, scale_factor=1.2, image_wh=(320, 240)).numpy()
    assert got.shape == want.shape == (2, N) and got.dtype == np.int32
    assert (got != want).sum() <= 0.005 * want.size
    assert (want[0] >= 0).sum() > 50 and 20 < (want[1] >= 0).sum() <= 40
    hit = want[0] >= 0
    np.testing.assert_array_equal(want[0][hit], np.nonzero(hit)[0])  # feature j re-detects point j


def test_block_from_store_and_kf_store_match_reference():
    from slam_framework_tpu.pipeline.kf_store import DeviceKFStore as JStore

    jarena = _arena([0.0, 0.5, 1.0], shared=20)
    jstore = JStore(8, N)
    jstore.ensure([0, 2], jarena)
    rng = np.random.default_rng(6)
    pack = rng.standard_normal((N, 9)).astype(np.float32)
    pack[:, 4] = rng.integers(0, 8, N)
    desc = rng.integers(0, 2**32, (N, 8), dtype=np.uint64).astype(np.uint32)
    jstore.set_from_device(1, jnp.asarray(pack), jnp.asarray(desc))
    # a store copied from the reference's, and one filled by the port's own methods
    copied = interop.kf_store(jstore, "cpu")
    own = TMapper(_cfg(tconf), interop.arena(jarena), TK, device="cpu").kf_store
    own.ensure([0, 2], interop.arena(jarena))
    own.set_from_device(1, torch.from_numpy(pack), interop.to_tensor(desc))
    for store in (copied, own):
        np.testing.assert_array_equal(store.packs.numpy(), np.asarray(jstore.packs))
        np.testing.assert_array_equal(interop.to_numpy(store.descs, uint32=True), np.asarray(jstore.descs))
        np.testing.assert_array_equal(store.present, jstore.present)
    idxs = np.array([2, 0, 1], np.int32)
    poses = jarena.kf_pose[idxs]
    cand = rng.random((3, N)) < 0.5
    want = jmap.block_from_store(jstore.packs, jstore.descs, jnp.asarray(idxs), jnp.asarray(poses), jnp.asarray(cand))
    got = tmap.block_from_store(own.packs, own.descs, *map(torch.from_numpy, (idxs, poses, cand)))
    for name in tmap.KFBlock._fields:
        g = getattr(got, name)
        np.testing.assert_array_equal(interop.to_numpy(g, uint32=name == "desc"), np.asarray(getattr(want, name)))
    assert got.octave.dtype == torch.int32


# ------------------------------------------------------------------ LocalMapper host logic


def _cfg(mod, **mapping):
    return mod.SlamConfig(camera=mod.CameraConfig(**CAM), capacity=mod.CapacityConfig(**CAP),
                          mapping=mod.MappingConfig(**mapping))


def _arena(txs, shared, owner=0, all_kfs=False, seed=0):
    """Reference arena: a keyframe per tx seeing the 64 scene points; the first
    `shared` points exist as map points seen by keyframes 0 and 1 (by every
    keyframe when all_kfs)."""
    pts, descs = _scene(seed)
    arena = JArena.create(jconf.CapacityConfig(**CAP), N)
    for i, tx in enumerate(txs):
        T = _pose(tx)
        xy = np.zeros((N, 2), np.float32)
        xy[:64] = _project(T, pts)
        desc = np.zeros((N, 8), np.uint32)
        desc[:64] = descs
        arena.add_keyframe(T, i, float(i), xy, np.full(N, -1.0, np.float32), np.full(N, -1.0, np.float32),
                           np.zeros(N, np.int16), np.zeros(N, np.float32), desc, np.arange(N) < 64,
                           np.full(N, -1, np.int32))
    for j in range(shared):
        d = float(np.linalg.norm(pts[j]))
        pid = arena.add_point(pts[j], descs[j], owner, (pts[j] / d).astype(np.float32), 0.5 * d, d)
        for k in (range(len(txs)) if all_kfs else (0, 1)):
            arena.associate(k, j, pid)
    return arena


def _mappers(jarena, **mapping):
    """A reference mapper on `jarena` and a port mapper on a copy of it."""
    return JMapper(_cfg(jconf, **mapping), jarena, JK), TMapper(_cfg(tconf, **mapping), interop.arena(jarena), TK, device="cpu")


def _assert_arenas_equal(ta, ja, atol=0.0):
    for f in dataclasses.fields(JArena):
        a, b = getattr(ja, f.name), getattr(ta, f.name)
        if isinstance(a, np.ndarray):
            if atol and a.dtype.kind == "f":
                np.testing.assert_allclose(b, a, atol=atol, rtol=0, err_msg=f.name)
            else:
                np.testing.assert_array_equal(b, a, err_msg=f.name)
        elif not dataclasses.is_dataclass(a):
            assert a == b, f.name


def test_mapper_device_follows_the_tracker(monkeypatch):
    assert mapper_device("cpu", 1) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mapper_device(torch.device("cuda", 0), 1) == torch.device("cuda", 0)  # no second card: the tracker's own
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert mapper_device("cuda:0", 1) == torch.device("cuda", 1)


def test_cull_points_matches_reference():
    jarena = _arena([0.0, 0.5, 1.0, 1.5], shared=40)
    jm_, tm_ = _mappers(jarena)
    rng = np.random.default_rng(7)
    pids = np.arange(40)
    for arena in (jarena, tm_.arena):
        arena.pt_n_visible[pids] = 10
        arena.pt_n_found[pids] = np.where(pids % 3 == 0, 1, 8)        # a third fail the found ratio
        one_view = pids[pids % 5 == 1]
        arena.remove_observations_batch(one_view.astype(np.int64), np.ones(len(one_view), np.int64))
    born = rng.integers(0, 4, 40)
    for m in (jm_, tm_):
        for p, b in zip(pids, born):
            m.note_new_points(int(p), int(b))
        m._cull_points(3)
    assert 5 < jarena.n_valid_pts < 40
    assert tm_.recent_points == jm_.recent_points
    _assert_arenas_equal(tm_.arena, jarena)


def test_cull_keyframes_matches_reference():
    jarena = _arena([0.0, 0.3, 0.6, 0.9], shared=64, all_kfs=True)
    jm_, tm_ = _mappers(jarena, kf_cull_min_age=1)
    erased = {"j": [], "t": []}
    jm_.on_erase_keyframe, tm_.on_erase_keyframe = erased["j"].append, erased["t"].append
    jm_._cull_keyframes(3)
    tm_._cull_keyframes(3)
    assert erased["t"] == erased["j"] and erased["j"] and all(k not in (0, 3) for k in erased["j"])
    assert tm_.totals["culled_keyframes"] == len(erased["t"])
    _assert_arenas_equal(tm_.arena, jarena)


def _fuse_scene():
    """kf1 owns a point per feature, the first 20 shared with kf0; a duplicate of
    point 30 is bound to kf0's feature 30 (the reference's SearchInNeighbors test)."""
    pts, descs = _scene()
    jarena = _arena([0.0, 0.5], shared=0)
    for j in range(64):
        d = float(np.linalg.norm(pts[j]))
        pid = jarena.add_point(pts[j], descs[j], 1, (pts[j] / d).astype(np.float32), 0.5 * d, d)
        jarena.associate(1, j, pid)
        if j < 20:
            jarena.associate(0, j, pid)
    d30 = float(np.linalg.norm(pts[30]))
    dup = jarena.add_point(pts[30] + 0.001, descs[30], 0, (pts[30] / d30).astype(np.float32), 0.5 * d30, d30)
    jarena.associate(0, 30, dup)
    return jarena, dup


def test_apply_fuse_adds_and_merges_like_reference():
    jarena, dup = _fuse_scene()
    jm_, tm_ = _mappers(jarena)
    nbr_ids, pids_pad, res = jm_._dispatch_fuse(1)
    assoc = np.asarray(res)
    t_nbr, t_pad, t_res = tm_._dispatch_fuse(1)
    np.testing.assert_array_equal(t_nbr, nbr_ids)
    np.testing.assert_array_equal(t_pad, pids_pad)
    assert (t_res.numpy() != assoc).sum() <= 0.005 * assoc.size
    # the same device result through both host write-backs
    jm_._apply_fuse(nbr_ids, pids_pad, None, prefetched=[assoc])
    tm_._apply_fuse(t_nbr, t_pad, None, prefetched=[assoc])
    assert tm_.last_fuse == jm_.last_fuse and jm_.last_fuse["added_obs"] > 30 and jm_.last_fuse["merged"] >= 1
    assert tm_.totals["fused_obs"] == jm_.last_fuse["added_obs"] and tm_.totals["merged"] == jm_.last_fuse["merged"]
    assert sum(bool(jarena.pt_valid[p]) for p in (30, dup)) == 1  # the duplicate pair became one point
    _assert_arenas_equal(tm_.arena, jarena)


def test_search_in_neighbors_end_to_end_matches_reference():
    jarena, _ = _fuse_scene()
    jm_, tm_ = _mappers(jarena)
    jm_._search_in_neighbors(1)
    tm_._search_in_neighbors(1)
    assert tm_.last_fuse == jm_.last_fuse
    _assert_arenas_equal(tm_.arena, jarena)


def test_triangulation_writeback_matches_reference():
    jarena = _arena([0.0, 1.0], shared=20)
    jm_, tm_ = _mappers(jarena)
    nbr_ids, res = jm_._dispatch_triangulation(1)
    t_nbr, t_res = tm_._dispatch_triangulation(1)
    np.testing.assert_array_equal(t_nbr, nbr_ids)
    pf = [np.asarray(a) for a in (res.ni, res.nf, res.pts, res.valid)]
    assert (t_res.valid.numpy() != pf[3]).sum() <= 0.005 * N
    assert np.abs(t_res.pts.numpy() - pf[2])[pf[3] & t_res.valid.numpy()].max() < 0.01
    before = jarena.n_valid_pts
    # the same device result through both host write-backs (each then dispatches its own fuse)
    jm_._apply_triangulation(1, nbr_ids, None, prefetched=pf)
    tm_._apply_triangulation(1, t_nbr, None, prefetched=pf)
    assert jarena.n_valid_pts - before > 30
    assert tm_.last_triangulation == jm_.last_triangulation
    assert tm_.recent_points == jm_.recent_points and len(tm_._fuse_pending) == len(jm_._fuse_pending) == 1
    _assert_arenas_equal(tm_.arena, jarena)


def _ba_pair(**mapping):
    jarena = _arena([0.0, 0.5, 1.0], shared=40, all_kfs=True, seed=1)
    rng = np.random.default_rng(8)
    jarena.pt_pos[:40] += rng.normal(0, 0.02, (40, 3)).astype(np.float32)
    jm_, tm_ = _mappers(jarena, **mapping)
    return jarena, jm_, tm_


def test_local_ba_problem_assembly_and_result_match_reference():
    jarena, jm_, tm_ = _ba_pair()
    jm_._local_ba(2)
    tm_._local_ba(2)
    jp, tp = jm_._ba_pendings[0], tm_._ba_pendings[0]
    assert tp["cams"] == jp["cams"] and tp["m"] == jp["m"] == 120
    for key in ("cam_fixed", "pid_set", "obs_mask", "pi_flat", "kf_flat", "ft_flat"):
        np.testing.assert_array_equal(tp[key], jp[key], err_msg=key)
    np.testing.assert_allclose(tp["res"].cam_pose.numpy(), np.asarray(jp["res"].cam_pose), atol=1e-3)
    np.testing.assert_array_equal(tp["res"].obs_inlier.numpy(), np.asarray(jp["res"].obs_inlier))
    jm_.flush_ba()
    tm_.flush_ba()
    assert tm_.totals["ba_applied"] == 1 and tm_.ba_aborts == jm_.ba_aborts == 0
    assert {k: v for k, v in tm_.last_ba_stats.items() if k != "chi2"} == \
        {k: v for k, v in jm_.last_ba_stats.items() if k != "chi2"}
    _assert_arenas_equal(tm_.arena, jarena, atol=1e-3)
    assert np.abs(jarena.kf_pose[1:3, :3, 3] - np.array([[-0.5, 0, 0], [-1.0, 0, 0]])).max() < 0.02


@pytest.mark.parametrize("bad_frac,aborted", [(0.10, False), (0.20, True)])
def test_apply_ba_divergence_guard_matches_reference(bad_frac, aborted):
    """The 15% guard: fed the same result, both packages either write it back
    (erasing the rejected observations) or discard it whole."""
    jarena, jm_, tm_ = _ba_pair()
    jm_._local_ba(2)
    tm_._local_ba(2)
    jp, tp = jm_._ba_pendings.pop(), tm_._ba_pendings.pop()
    m = jp["m"]
    rng = np.random.default_rng(9)
    inlier = np.ones(len(jp["obs_mask"]), bool)
    inlier[rng.choice(m, int(bad_frac * m), replace=False)] = False
    C, P = _cfg(tconf).capacity.ba_cams, _cfg(tconf).capacity.ba_points
    new_cam = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    new_cam[:3] = jarena.kf_pose[jp["cams"]]
    new_cam[:3, :3, 3] += 0.01
    new_pt = np.zeros((P, 3), np.float32)
    new_pt[: len(jp["pid_set"])] = jarena.pt_pos[jp["pid_set"]] + 0.005
    pf = [new_cam, new_pt, inlier, np.float32(12.5)]
    before = interop.arena(jarena)
    jm_._apply_ba(jp, pf)
    tm_._apply_ba(tp, pf)
    assert tm_.ba_aborts == jm_.ba_aborts == int(aborted)
    assert tm_.last_ba_stats == jm_.last_ba_stats and ("aborted_divergent" in tm_.last_ba_stats) == aborted
    assert tm_.totals["ba_applied"] == int(not aborted)
    _assert_arenas_equal(tm_.arena, jarena)
    changed = not np.array_equal(before.kf_pose, jarena.kf_pose)
    assert changed == (not aborted)
    if not aborted:
        assert jm_.last_ba_stats["outliers"] == int(bad_frac * m)


@pytest.mark.parametrize("policy", ["discard", "lag", "block"])
def test_writeback_policy_matches_reference(policy):
    """config.MappingConfig.{ba,trifuse}_writeback at keyframe arrival, as the
    reference's TestWritebackPolicy drives it."""
    mapping = dict(triangulate_new_points=False, cull_keyframes=False)
    mapping.update({"discard": dict(ba_writeback="discard"), "block": dict(ba_writeback="block"),
                    "lag": dict(ba_writeback="block", trifuse_writeback="lag")}[policy])
    jarena, jm_, tm_ = _ba_pair(**mapping)
    for m in (jm_, tm_):
        if policy == "lag":
            pending = m._dispatch_fuse(1)
            assert pending is not None
            m._fuse_pending.append(pending)
            m.process_keyframe(1)  # nothing prefetched: lag keeps it in flight
            assert m._fuse_pending and m._fuse_pending[0] is pending
            m.finalize()           # the next drain (or shutdown) lands it
            assert not m._fuse_pending and not m._ba_pendings
        else:
            m._local_ba(2)         # in flight, as if dispatched at the previous keyframe
            assert m._ba_pendings
            m.process_keyframe(2)  # a new keyframe arrives, nothing prefetched
            assert m.ba_aborts == (1 if policy == "discard" else 0)
            assert len(m._ba_pendings) == 1  # this keyframe's own dispatch
            if policy == "block":
                assert m.last_ba_stats.get("cams", 0) >= 2  # the old BA landed
    assert tm_.ba_aborts == jm_.ba_aborts
    _assert_arenas_equal(tm_.arena, jarena, atol=1e-3)
