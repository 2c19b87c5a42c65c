"""Parity of the port's Hamming matrix and gated matchers with the reference
(matching/hamming.py, matching/matcher.py, pipeline/track_ops._invert_matches).

Tolerance: none. Hamming distances are integers computed exactly on both sides
(a 0/1 fp32 product with partial sums <= 256); the matchers are argmin,
comparisons and masks over those integers, with first-index tie breaking on
both sides.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slam_framework_tpu.matching import hamming as jham
from slam_framework_tpu.matching import matcher as jm
from slam_framework_tpu.ops import brief as jbrief
from slam_framework_tpu.pipeline import track_ops as jtrack
from slam_framework_torch import interop
from slam_framework_torch.matching import hamming as tham
from slam_framework_torch.matching import matcher as tm
from slam_framework_torch.ops import brief as tbrief
from slam_framework_torch.pipeline import track_ops as ttrack


def _desc(n, seed):
    return np.random.default_rng(seed).integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)


def _near_copies(base, n, flips, seed):
    """Descriptors at small Hamming distance from rows of `base` (so matches exist)."""
    rng = np.random.default_rng(seed)
    out = base[rng.integers(0, len(base), n)].copy()
    for i in range(n):
        for _ in range(flips):
            w, b = rng.integers(0, 8), rng.integers(0, 32)
            out[i, w] ^= np.uint32(1 << int(b))
    return out


def _ham_pair(seed=0, n=120, m=150):
    a = _desc(n, seed)
    b = np.concatenate([_near_copies(a, m // 2, 10, seed + 1), _desc(m - m // 2, seed + 2)])
    return a, b


def test_hamming_matrix_exact():
    a, b = _ham_pair()
    want = np.asarray(jham.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = tham.hamming_matrix(interop.to_tensor(a), interop.to_tensor(b)).numpy()
    np.testing.assert_array_equal(got, want)


def test_bit_packing_roundtrip_matches_reference():
    d = _desc(40, 3)
    bits = np.asarray(jbrief.unpack_bits(jnp.asarray(d)))
    np.testing.assert_array_equal(tham.unpack_to_bits(interop.to_tensor(d)).numpy(), bits)
    packed = tbrief.pack_bits(torch.from_numpy(bits.astype(bool)))
    np.testing.assert_array_equal(interop.to_numpy(packed, uint32=True), d)


@pytest.mark.parametrize(
    "kwargs", [dict(max_dist=100), dict(max_dist=50, nn_ratio=0.7, mutual=True), dict(max_dist=75, nn_ratio=0.9)]
)
def test_gated_match_exact(kwargs):
    a, b = _ham_pair(4)
    ham = np.array(jham.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    gate = np.random.default_rng(5).random(ham.shape) < 0.6
    want = jm.gated_match(jnp.asarray(ham), jnp.asarray(gate), **kwargs)
    got = tm.gated_match(torch.from_numpy(ham), torch.from_numpy(gate), **kwargs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got.count) == int(want.count) > 0


def _match_result(seed, n=200, m=160):
    rng = np.random.default_rng(seed)
    valid = rng.random(n) < 0.7
    idx = np.where(valid, rng.integers(0, m, n), -1).astype(np.int32)
    dist = np.where(valid, rng.integers(0, 12, n), jm.BIG).astype(np.int32)  # many ties
    return (jm.MatchResult(jnp.asarray(idx), jnp.asarray(dist), jnp.asarray(valid)),
            tm.MatchResult(torch.from_numpy(idx), torch.from_numpy(dist), torch.from_numpy(valid)), m)


def test_resolve_duplicate_columns_and_invert_exact():
    jres, tres, m = _match_result(6)
    want = jm.resolve_duplicate_columns(jres, m)
    got = tm.resolve_duplicate_columns(tres, m)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(ttrack._invert_matches(tres, 200, m).numpy(),
                                  np.asarray(jtrack._invert_matches(jres, 200, m)))


def test_rotation_consistency_exact():
    jres, tres, m = _match_result(7)
    rng = np.random.default_rng(8)
    # clustered orientation deltas so the histogram has ties and clear modes
    a = rng.uniform(-np.pi, np.pi, 200).astype(np.float32)
    b = (rng.uniform(-np.pi, np.pi, m) + rng.choice([0.0, 0.3, 2.0], m)).astype(np.float32)
    want = jm.rotation_consistency(jnp.asarray(a), jnp.asarray(b), jres)
    got = tm.rotation_consistency(torch.from_numpy(a), torch.from_numpy(b), tres)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_window_and_octave_gates_exact():
    rng = np.random.default_rng(9)
    pred = rng.uniform(0, 640, (80, 2)).astype(np.float32)
    feat = rng.uniform(0, 640, (90, 2)).astype(np.float32)
    radius = rng.uniform(5, 60, 80).astype(np.float32)
    np.testing.assert_array_equal(
        tm.window_gate(*map(torch.from_numpy, (pred, feat, radius))).numpy(),
        np.asarray(jm.window_gate(jnp.asarray(pred), jnp.asarray(feat), jnp.asarray(radius))),
    )
    po = rng.integers(0, 8, 80).astype(np.int32)
    fo = rng.integers(0, 8, 90).astype(np.int32)
    np.testing.assert_array_equal(
        tm.octave_gate(torch.from_numpy(po), torch.from_numpy(fo)).numpy(),
        np.asarray(jm.octave_gate(jnp.asarray(po), jnp.asarray(fo))),
    )
