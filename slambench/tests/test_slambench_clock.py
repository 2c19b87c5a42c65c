"""The rate and latency arithmetic on synthetic call times."""

import numpy as np
import pytest

from slambench import clock


def _pipeline(n_frames, chunk=4, depth=2, slow=1.0, fast=0.01):
    """Calls of a chunked tracker: every `chunk`-th call takes `slow` s and,
    from the (depth)-th chunk on, brings back the chunk dispatched depth-1
    chunks earlier; the other calls take `fast` s and bring nothing back."""
    start, end, n_rec = [], [], []
    t = 0.0
    recs = 0
    for f in range(n_frames):
        start.append(t)
        full = (f + 1) % chunk == 0
        t += slow if full else fast
        end.append(t)
        if full and f + 1 >= chunk * depth:
            recs += chunk
        n_rec.append(recs)
    return np.array(start), np.array(end), np.array(n_rec)


def test_first_calls_holding():
    assert clock.first_calls_holding([0, 0, 2, 2, 5], 6).tolist() == [2, 2, 4, 4, 4, -1]


def test_window_rate_and_latency():
    start, end, n_rec = _pipeline(40)
    returned = clock.first_calls_holding(n_rec, 40)
    lost = np.zeros(40, bool)
    win = clock.window(start, end, returned, lost, 8, 32)
    # 24 calls: 6 slow, 18 fast; chunks 1..6 (frames 4..27) came back in calls 11..31
    assert win["window_s"] == pytest.approx(6 * 1.0 + 18 * 0.01)
    assert win["frames_posed"] == 24
    assert win["frames_per_s"] == pytest.approx(24 / 6.18)
    assert win["attempted"] == 24 and win["failed"] == 0
    # frames 28..31 come back after the window (call 35); their latency counts
    assert win["latency_samples"] == 24
    # frame 8 (first of its chunk): calls 8..15 -> 3 fast + slow + 3 fast + slow
    lat_first = 2 * 1.0 + 6 * 0.01
    lat_last = 1.0 + 1.0 + 3 * 0.01  # frame 11: its own slow call, 3 fast, one slow
    assert win["latency_p_ms"] <= lat_first * 1e3 + 1e-9
    assert win["latency_median_ms"] >= lat_last * 1e3 - 1e-9


def test_lost_and_missing_frames_fail():
    start, end, n_rec = _pipeline(24)
    returned = clock.first_calls_holding(n_rec, 24)
    lost = np.zeros(24, bool)
    lost[9] = True
    win = clock.window(start, end, returned, lost, 8, 24)
    # frames 20..23 never come back (no call after them), frame 9 is lost
    assert win["failed"] == 4 + 1
    assert win["frames_posed"] == 16 - 1


def test_arrival_and_skip():
    start, end, n_rec = _pipeline(40)
    returned = clock.first_calls_holding(n_rec, 40)
    lost = np.zeros(40, bool)
    base = clock.window(start, end, returned, lost, 8, 32)
    # a timed feed: each frame arrived 0.5 s before its call started
    late = clock.window(start, end, returned, lost, 8, 32, arrival=start - 0.5)
    assert late["latency_median_ms"] == pytest.approx(base["latency_median_ms"] + 500.0)
    assert late["frames_per_s"] == base["frames_per_s"] and late["window_s"] == base["window_s"]
    # frames whose wait overlaps a stretch are left out of the latency sample only
    cut = clock.window(start, end, returned, lost, 8, 32, skip=(start[16], end[19]))
    assert cut["latency_samples"] < base["latency_samples"] and cut["frames_posed"] == base["frames_posed"]
    t_back = end[returned[8:32]]
    overlaps = ~((t_back < start[16]) | (start[8:32] > end[19]))
    assert cut["latency_samples"] == base["latency_samples"] - int(overlaps.sum())
