"""The end-to-end arithmetic of a closed-loop run, from the host clock.

Every frame f is handed in by one call, `start[f]` to `end[f]` (perf_counter
seconds); `arrival[f]` is when it was there to be handed in (its call's start
in a closed loop, its due time in a timed feed); `returned[f]` is the index
of the first call after which the program holds a record of frame f (its pose
or its loss). The window is the calls `lo` .. `hi - 1`: it opens when call
`lo` starts and closes when call `hi - 1` returns, so the rate takes all the
work and all the time of it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def first_calls_holding(n_records_after: Sequence[int], n_frames: int) -> np.ndarray:
    """For record index j (0 .. n_frames-1), the first call after which the
    program held more than j records; -1 where it never did."""
    counts = np.asarray(n_records_after, np.int64)
    # counts never fall while one tracker runs, so the first call with count > j
    # is a binary search over the running maximum
    running = np.maximum.accumulate(counts) if len(counts) else counts
    j = np.arange(n_frames)
    idx = np.searchsorted(running, j, side="right")
    return np.where(idx < len(counts), idx, -1)


def window(start: Sequence[float], end: Sequence[float], returned: Sequence[int], lost: Sequence[bool],
           lo: int, hi: int, percentile: float = 95.0, arrival: Optional[Sequence[float]] = None,
           skip: Optional[Tuple[float, float]] = None) -> Dict[str, float]:
    """The window's numbers: frames whose pose came back in it per second,
    the latency percentile over the frames handed in during it (arrival, by
    default the handing-in call's start, to the return of the call after which
    its record exists), and the counts behind them. A frame whose record never
    came back has no latency and counts as failed. `skip` = (t_a, t_b) leaves
    out of the latency sample the frames whose wait overlaps that stretch."""
    start = np.asarray(start, np.float64)
    arrival = start if arrival is None else np.asarray(arrival, np.float64)
    end = np.asarray(end, np.float64)
    returned = np.asarray(returned, np.int64)
    lost = np.asarray(lost, bool)
    t0, t1 = start[lo], end[hi - 1]
    seconds = t1 - t0
    frames = np.arange(len(returned))
    back_in_window = (returned >= lo) & (returned < hi)
    posed = int((back_in_window & ~lost).sum())
    handed = frames[lo:hi]
    came = returned[handed] >= 0
    t_back = end[returned[handed][came]]
    t_in = arrival[handed][came]
    lat = t_back - t_in
    if skip is not None:
        lat = lat[(t_back < skip[0]) | (t_in > skip[1])]
    return {
        "window_s": float(seconds),
        "frames_per_s": posed / seconds,
        "frames_posed": posed,
        "attempted": int(hi - lo),
        "failed": int((~came).sum() + (lost[handed][came]).sum()),
        "latency_samples": int(len(lat)),
        "latency_p_ms": float(np.percentile(lat, percentile) * 1e3) if len(lat) else float("nan"),
        "latency_median_ms": float(np.median(lat) * 1e3) if len(lat) else float("nan"),
    }
