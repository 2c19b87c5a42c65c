"""The device trace of a bounded stretch of whole chunks inside a traced window.

`torch.profiler` records the host's ranges (the tracker's `tracker/*` spans)
and the device's operations. A stretch opens right after a call that brought
records back (a chunk boundary) and closes right after `chunks` more such
calls: at ~12,800 kernels a frame, a whole window would be millions of events.
From the events: the device operations (kernels, copies, sets) with their
intervals, each kernel's launch time (the runtime launch call that shares its
correlation id, as `kernel_launches` of the port's
`tools/profile_main_path.py` pairs them), and the host ranges by name.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

LAUNCH_CALLS = ("cudaLaunch", "cuLaunch")


def merge(ranges) -> List[List[float]]:
    """Union of (start, end) ranges, sorted and disjoint."""
    out: List[List[float]] = []
    for a, b in sorted(ranges):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def inside(times: np.ndarray, merged: List[List[float]]) -> np.ndarray:
    """Whether each time lies in one of the merged ranges."""
    if not merged:
        return np.zeros(len(times), bool)
    starts = np.array([a for a, _ in merged])
    ends = np.array([b for _, b in merged])
    i = np.searchsorted(starts, times, side="right") - 1
    ok = i >= 0
    res = np.zeros(len(times), bool)
    res[ok] = times[ok] <= ends[i[ok]]
    return res & ~np.isnan(times)


class TraceData:
    """What a reader takes from the stretch. Times are microseconds on the
    profiler's one clock. `events` are the profiler's raw (kineto) events:
    building its Python event tree for ~10^6 events would take minutes."""

    def __init__(self, events, wall_s: float):
        self.wall_s = wall_s
        names, starts, ends, corr = [], [], [], []
        launch: Dict[int, float] = {}
        self.spans: Dict[str, List[Tuple[float, float]]] = collections.defaultdict(list)
        cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
        for e in events:
            name = e.name()
            device = e.device_type()
            start = e.start_ns() / 1e3
            if device == cuda:
                # the tracker's ranges are mirrored onto the device timeline: not device work
                if e.is_user_annotation() or name.startswith("tracker/"):
                    continue
                names.append(name)
                starts.append(start)
                ends.append(start + e.duration_ns() / 1e3)
                corr.append(e.correlation_id())
            elif device == cpu:
                if name.startswith(LAUNCH_CALLS):
                    launch[e.correlation_id()] = start
                elif name.startswith("tracker/"):
                    self.spans[name].append((start, start + e.duration_ns() / 1e3))
        self.op_names = names
        self.op_start = np.array(starts, np.float64)
        self.op_end = np.array(ends, np.float64)
        self.is_kernel = np.array([not n.startswith(("Memcpy", "Memset")) for n in names], bool)
        self.op_launch = np.array([launch.get(c, np.nan) for c in corr], np.float64)
        self.frames = len(self.spans.get("tracker/frontend", []))
        self.busy = merge(zip(self.op_start.tolist(), self.op_end.tolist()))
        self.busy_s = sum(b - a for a, b in self.busy) / 1e6

    def kernels_launched_in(self, span_names) -> np.ndarray:
        """Mask of the kernels whose launch call ran inside the named spans."""
        merged = merge(r for n in span_names for r in self.spans.get(n, []))
        return self.is_kernel & inside(self.op_launch, merged)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time, and the device's
        idle time between operations summed by the innermost tracker span the
        host was in at the middle of each gap."""
        by_name = collections.Counter()
        for name, a, b in zip(self.op_names, self.op_start, self.op_end):
            by_name[name[:120]] += (b - a) / 1e6
        names = sorted(self.spans)
        busy = np.array(self.busy, np.float64).reshape(-1, 2)
        gap_s = (busy[1:, 0] - busy[:-1, 1]) / 1e6
        mid = 0.5 * (busy[1:, 0] + busy[:-1, 1])
        label = np.full(len(mid), -1)
        best = np.full(len(mid), -np.inf)
        for k, n in enumerate(names):
            for a, b in self.spans[n]:
                m = (mid >= a) & (mid <= b) & (a > best)
                label[m] = k
                best[m] = a
        gaps = collections.Counter()
        for k, s in zip(label.tolist(), gap_s.tolist()):
            gaps[names[k] if k >= 0 else "outside tracker spans"] += s
        return {"device_ops": [[n, s] for n, s in by_name.most_common(top)],
                "idle_gaps": [[n, s] for n, s in gaps.most_common(top)]}


class Stretch:
    """Opens the profiler at the first chunk boundary `after_s` into the
    window and closes it `chunks` chunk boundaries later, or where the window
    ends if that comes first."""

    def __init__(self, after_s: float, chunks: int):
        self.after_s = after_s
        self.chunks = chunks
        self.prof = None
        self.seen = 0
        self.t_open = self.t_close = None
        self.done = False

    def on_call(self, since_open_s: float, brought_records: bool) -> None:
        if self.done or not brought_records:
            return
        if self.prof is None:
            if since_open_s >= self.after_s:
                acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
                self.prof = torch.profiler.profile(activities=acts)
                self.prof.start()
                self.t_open = time.perf_counter()
            return
        self.seen += 1
        if self.seen >= self.chunks:
            torch.cuda.synchronize()
            self.t_close = time.perf_counter()
            self.prof.stop()
            self.done = True

    def close(self) -> None:
        """End the stretch where the window ends, if it is still open."""
        if self.prof is not None and not self.done:
            torch.cuda.synchronize()
            self.t_close = time.perf_counter()
            self.prof.stop()
            self.done = True

    def data(self) -> Optional[TraceData]:
        if not self.done:
            return None
        return TraceData(self.prof.profiler.kineto_results.events(), self.t_close - self.t_open)
