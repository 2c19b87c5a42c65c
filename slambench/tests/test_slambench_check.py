"""The check's own arithmetic: the FAST sample and the judging of numbers."""

import math

import numpy as np

from slambench import check


def test_fast_sample_is_a_uniform_reservoir_of_the_window():
    counts = np.zeros(100)
    for seed in range(400):
        rec = check.FastRecorder(np.random.default_rng([seed, 7]), first=10, count=4)
        for fid in range(110):
            slot = rec._keep(fid)
            if slot is not None:
                rec.captured.pop(slot, None)
                rec.captured[fid] = None
        assert len(rec.captured) == 4 and all(10 <= k < 110 for k in rec.captured)
        counts[np.array(sorted(rec.captured)) - 10] += 1
    assert counts.sum() == 1600 and counts.min() > 0 and counts.max() < 3 * counts.mean()
    rec.active = False
    assert rec._keep(200) is None


def test_judge_fails_nan_and_values_over_the_limit():
    out = check.judge({"a": 0.5, "b": math.nan, "c": 2.0}, {"a": {"limit": 1.0}, "b": {"limit": 1.0},
                                                            "c": {"limit": 1.0}, "d": {"limit": 1.0}})
    assert [out[k]["ok"] for k in "abcd"] == [True, False, False, False]
