"""Parity of the port's vocabulary tree and keyframe database with the reference
(bow/vocabulary.py, bow/database.py): seeded numpy descriptors through both.

Tolerance 0 throughout: the descent is integer arithmetic (XOR, popcount,
argmin with the first child winning a tie) and the database is host numpy
copied from the reference. `transform` returns exactly the reference's word
ids, level-up groups and weights, on the shipped 110,343-node vocabulary
(2048 descriptors, among them node centres themselves and descriptors a few
bits from a centre, where Hamming ties between children are the rule) and on a
small vocabulary trained here; `train`, `transform_host`, `refit_idf` and both
file formats give the reference's tables; `BowFrame.score` and both candidate
lists are equal on a seeded database.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_framework_tpu.bow import database as jdb, vocabulary as jvoc
from slam_framework_torch import interop
from slam_framework_torch.bow import database as tdb, vocabulary as tvoc


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once; torch's default of one
    thread per core in each of them oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _clustered(seed=4, n_clusters=50, per=40, flips=6):
    r = np.random.default_rng(seed)
    centers = r.integers(0, 2**32, (n_clusters, 8), dtype=np.uint64).astype(np.uint32)
    out = np.repeat(centers, per, axis=0)
    for _ in range(flips):
        w = r.integers(0, 8, len(out))
        out[np.arange(len(out)), w] ^= (np.uint32(1) << r.integers(0, 32, len(out)).astype(np.uint32))
    return out


def _assert_same_vocab(t, j):
    assert (t.k, t.depth, t.levelsup) == (j.k, j.depth, j.levelsup)
    for f in ("node_desc", "node_children", "node_weight", "node_word"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
        assert getattr(t, f).dtype == getattr(j, f).dtype


def _transform_both(jv, tv, desc, valid):
    want = jax.jit(jvoc.transform, static_argnames=("depth", "k"))(
        jv.device_tables(), jnp.asarray(desc), jnp.asarray(valid), depth=jv.depth, k=jv.k)
    got = tvoc.transform(tv.device_tables("cpu"), interop.to_tensor(desc), torch.from_numpy(valid), tv.depth, tv.k)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.fixture(scope="module")
def shipped():
    jv = jvoc.load(tvoc.SHIPPED_VOCABULARY.replace("slam_framework_torch", "slam_framework_tpu"))
    return jv, tvoc.load(tvoc.SHIPPED_VOCABULARY)


def test_shipped_vocabulary_loads_equal(shipped):
    jv, tv = shipped
    _assert_same_vocab(tv, jv)
    assert (tv.k, tv.depth, tv.num_nodes) == (10, 5, 110343)
    _assert_same_vocab(interop.vocabulary(jv), jv)


def test_transform_on_shipped_vocabulary_exactly_equal(shipped):
    jv, tv = shipped
    r = np.random.default_rng(0)
    desc = r.integers(0, 2**32, (2048, 8), dtype=np.uint64).astype(np.uint32)
    # node centres themselves and near-centre descriptors: ties between children
    nodes = r.integers(1, jv.num_nodes, 1024)
    desc[:1024] = jv.node_desc[nodes]
    desc[512:1024, 3] ^= np.uint32(0x00010010)
    desc[1024:1040] = 0
    desc[1040:1056] = 0xFFFFFFFF
    valid = r.random(2048) < 0.9
    got, want = _transform_both(jv, tv, desc, valid)
    for g, w, name in zip(got, want, ("word", "group", "weight")):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[0].dtype == np.int32 and got[2].dtype == np.float32
    assert (got[0][~valid] == -1).all() and (got[1][~valid] == -1).all() and (got[2][~valid] == 0).all()
    assert len(np.unique(got[0][valid])) > 1000 and (got[0][valid] >= 0).all()
    np.testing.assert_array_equal(tvoc.transform_host(tv, desc), jvoc.transform_host(jv, desc))
    np.testing.assert_array_equal(tvoc.transform_host(tv, desc)[valid], got[0][valid])


@pytest.fixture(scope="module")
def trained():
    descs = _clustered()
    return descs, jvoc.train(descs, k=5, depth=3, seed=0), tvoc.train(descs, k=5, depth=3, seed=0)


def test_train_gives_the_reference_tree_and_transform_matches(trained):
    descs, jv, tv = trained
    _assert_same_vocab(tv, jv)
    assert tv.num_words > 20
    valid = np.ones(len(descs), bool)
    valid[::7] = False
    got, want = _transform_both(jv, tv, descs, valid)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # levelsup larger than the depth: the group stays the root, as in the reference
    assert (got[1][valid] == 0).all()


def test_refit_idf_and_file_formats_match_reference(trained, tmp_path):
    descs, jv, tv = trained
    jv, tv = dataclasses.replace(jv, node_weight=jv.node_weight.copy()), dataclasses.replace(tv, node_weight=tv.node_weight.copy())
    lists = [jvoc.transform_host(jv, descs[i::10]) for i in range(10)]
    jvoc.refit_idf(jv, lists)
    tvoc.refit_idf(tv, [tvoc.transform_host(tv, descs[i::10]) for i in range(10)])
    _assert_same_vocab(tv, jv)
    assert len(np.unique(tv.node_weight)) > 3
    tvoc.save_npz(tv, str(tmp_path / "t.npz"))
    jvoc.save_npz(jv, str(tmp_path / "j.npz"))
    _assert_same_vocab(tvoc.load(str(tmp_path / "t.npz")), jvoc.load(str(tmp_path / "j.npz")))
    _assert_same_vocab(tvoc.load(str(tmp_path / "j.npz")), jv)
    tvoc.save_orbvoc_text(tv, str(tmp_path / "t.txt"))
    jvoc.save_orbvoc_text(jv, str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    # the text format numbers the words anew, in file order, in both packages
    _assert_same_vocab(tvoc.load(str(tmp_path / "t.txt")), jvoc.load(str(tmp_path / "j.txt")))


def test_bowframe_score_and_candidate_lists_equal(trained):
    descs, jv, tv = trained
    r = np.random.default_rng(9)
    n_kf = 30
    jd, td = jdb.KeyframeDatabase(jv.num_words), tdb.KeyframeDatabase(tv.num_words)
    jframes, tframes = [], []
    for k in range(n_kf):
        # neighbouring keyframes share clusters: a sliding window over the 50 clusters
        sel = np.concatenate([np.arange(c * 40, c * 40 + 40) for c in (np.arange(k, k + 8) % 50)])
        sel = sel[r.random(len(sel)) < 0.7]
        words = jvoc.transform_host(jv, descs[sel])
        weights = jv.node_weight[np.nonzero(jv.node_word >= 0)[0]][words] * r.uniform(0.5, 2.0, len(words)).astype(np.float32)
        jframes.append(jdb.BowFrame(words, weights))
        tframes.append(tdb.BowFrame(words.copy(), weights.copy()))
        np.testing.assert_array_equal(tframes[-1].words, jframes[-1].words)
        np.testing.assert_array_equal(tframes[-1].values, jframes[-1].values)
    for k in range(n_kf - 4):
        jd.add(k, jframes[k])
        td.add(k, tframes[k])
    jd.erase(3)
    td.erase(3)
    assert td.index == jd.index and set(td.frames) == set(jd.frames)
    groups = {k: [k] + [j for j in (k - 1, k + 1) if 0 <= j < n_kf] for k in range(n_kf)}
    n_lists = 0
    for q in range(n_kf):
        for other in (0, 5, q):
            assert tframes[q].score(tframes[other]) == jframes[q].score(jframes[other])
        connected = {q, q - 1, q + 1}
        for min_score in (0.0, 0.05):
            want = jd.detect_loop_candidates(jframes[q], min_score, connected, covisibility_groups=groups)
            assert td.detect_loop_candidates(tframes[q], min_score, connected, covisibility_groups=groups) == want
            n_lists += bool(want)
        want = jd.detect_relocalization_candidates(jframes[q], covisibility_groups=groups)
        assert td.detect_relocalization_candidates(tframes[q], covisibility_groups=groups) == want
        assert td.detect_relocalization_candidates(tframes[q]) == jd.detect_relocalization_candidates(jframes[q])
    assert n_lists > 10
