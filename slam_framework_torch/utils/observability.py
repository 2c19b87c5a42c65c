"""Structured metrics, stage timers and profiler spans.

Copy of slam_framework_tpu/utils/observability.py; `trace_span` names a range in
the torch.profiler timeline instead of the JAX profiler's, and `start_trace` /
`stop_trace` capture that timeline (the host's spans and, on a CUDA device,
its kernels) into a Chrome trace file in place of an xprof one.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch


class StageTimers:
    """Wall-clock accumulators keyed by stage name."""

    def __init__(self):
        self.total_s: dict[str, float] = {}
        self.count: dict[str, int] = {}

    @contextlib.contextmanager
    def time(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.total_s[name] = self.total_s.get(name, 0.0) + dt
            self.count[name] = self.count.get(name, 0) + 1

    def summary(self) -> dict:
        """Per-stage totals + means, in milliseconds."""
        out = {}
        for name, tot in sorted(self.total_s.items()):
            n = self.count[name]
            out[name] = {
                "total_ms": round(tot * 1e3, 2),
                "count": n,
                "mean_ms": round(tot / n * 1e3, 3),
            }
        return out

    def merge(self, other: "StageTimers") -> None:
        for k, v in other.total_s.items():
            self.total_s[k] = self.total_s.get(k, 0.0) + v
            self.count[k] = self.count.get(k, 0) + other.count[k]


class MetricsLog:
    """Append-only structured event log (per-frame + per-keyframe records)."""

    def __init__(self):
        self.records: list[dict] = []

    def add(self, **fields) -> None:
        self.records.append(fields)

    def __len__(self) -> int:
        return len(self.records)

    def frames(self) -> list[dict]:
        return [r for r in self.records if r.get("event", "frame") == "frame"]

    def keyframes(self) -> list[dict]:
        return [r for r in self.records if r.get("event") == "keyframe"]

    def summary(self) -> dict:
        fr = self.frames()
        kf = self.keyframes()
        out: dict = {"frames": len(fr), "keyframes": len(kf)}
        if fr:
            inl = np.array([r.get("inliers", 0) for r in fr], np.float64)
            out["inliers_mean"] = round(float(inl.mean()), 1)
            out["inliers_p5"] = round(float(np.percentile(inl, 5)), 1)
            out["lost_frames"] = sum(1 for r in fr if r.get("lost"))
        return out

    def to_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for r in self.records:
                f.write(json.dumps(r, default=_json_default) + "\n")


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


@contextlib.contextmanager
def trace_span(name: str) -> Iterator[None]:
    """Named range in the torch.profiler timeline (free when no profiler runs)."""
    with torch.profiler.record_function(name):
        yield


TRACE_FILE = "trace.json"
_trace: Optional[tuple] = None  # (torch.profiler.profile, log_dir) while a capture runs


def start_trace(log_dir: Optional[str]) -> bool:
    """Begin a torch.profiler capture of the host's spans and, when CUDA is
    available, the device's kernels; `stop_trace` ends it and writes it to
    `log_dir` (None: nothing is written). False when a capture already runs."""
    global _trace
    if _trace is not None:
        return False
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _trace = (prof, log_dir)
    return True


def stop_trace():
    """End the capture of `start_trace`, write it as `log_dir/trace.json`
    (Chrome trace format, readable by Perfetto and chrome://tracing) and return
    the profiler, whose `events()` hold the capture; None when none runs."""
    global _trace
    if _trace is None:
        return None
    (prof, log_dir), _trace = _trace, None
    prof.stop()
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
    return prof
