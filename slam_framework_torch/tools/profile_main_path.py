"""Device busy share of the main path (tracker + local mapper) on one CUDA device.

    python -m slam_framework_torch.tools.profile_main_path [--warm 81] [--window 24] [--depth 2 ...] [--trace DIR]

Tracks the bench world at `SlamConfig()` defaults through `track_stereo_device`:
`--warm` frames first (the map grows past its bootstrap), then one window of
`--window` frames on the host clock alone, then a second window under
`torch.profiler` (`utils/observability.start_trace`; `--trace DIR` writes it to
DIR/run<i>_depth<d>/trace.json, Chrome trace format). Prints one JSON line per
run: per window the wall time, frames/s, the keyframes made and the stage
timers; from the profiled window the number of kernels, their summed device
time and the largest entries by name, and per tracker span (`tracker/dispatch`,
`fetch`, `process`, `deferred`, ...) its host ms, the device ms of the kernels
that ran while the host was inside it, and how much of that was launched before
the span began (a kernel's launch is the runtime call that shares its
correlation id). Under `tracker/deferred` that part is the dispatched chunk's
tail that the pipeline's deferred stage overlaps, the rest the mapper's own
launches. The busy share is kernel time of the profiled window over the wall
time of the unprofiled one (the profiler slows the host, which is the
bottleneck). `--depth` sets the tracker's pipeline depth (default 2, the
tracker's own; 1 is the serial order); several values (`--depth 1 2 2 1`) run
one fresh system each, in turns, on frames rendered once. Needs a CUDA device;
it does not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import time

import numpy as np
import torch

from slam_framework_torch.config import SlamConfig
from slam_framework_torch.system import SlamSystem
from slam_framework_torch.tools.track_bench_world import bench_world
from slam_framework_torch.utils import cuda_timing, observability


LAUNCH_CALLS = ("cudaLaunch", "cuLaunch")  # the CUDA API calls that launch a kernel


def _timer_totals(timers) -> dict:
    return {k: v["total_ms"] for k, v in timers.summary().items()}


def _device_us(e) -> float:  # the attribute was renamed between PyTorch versions
    return e.device_time if hasattr(e, "device_time") else e.cuda_time


def span_overlap(spans, kernels, launch_us=None) -> dict:
    """Per span name: the host us inside its ranges (their union), the device
    us of the kernels that ran within them, and of those the part of kernels
    launched before the range began (work queued earlier, such as a dispatched
    chunk's tail; `launch_us` per kernel, NaN where unknown). `spans` and
    `kernels` are torch.profiler events, on the profiler's one clock."""
    ks = np.array([k.time_range.start for k in kernels], np.float64)
    ke = np.array([k.time_range.end for k in kernels], np.float64)
    kl = np.full(len(kernels), np.nan) if launch_us is None else np.asarray(launch_us, np.float64)
    by_name = collections.defaultdict(list)
    for e in spans:
        by_name[e.name].append((e.time_range.start, e.time_range.end))
    out = {}
    for name, ranges in sorted(by_name.items()):
        merged = []
        for a, b in sorted(ranges):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        dev = queued = 0.0
        for a, b in merged:
            inside = np.clip(np.minimum(ke, b) - np.maximum(ks, a), 0.0, None)
            dev += float(inside.sum())
            queued += float(inside[kl < a].sum())
        out[name] = {"ranges": len(ranges), "host_ms": sum(b - a for a, b in merged) / 1e3,
                     "device_ms": dev / 1e3, "device_ms_queued_before": queued / 1e3}
    return out


def kernel_launches(events, kernels) -> tuple:
    """Each kernel's launch time: the start of the CUDA API launch call
    that shares its CUPTI correlation id (NaN where none is found), and how many
    were found and how many of those start after their kernel (on an idle
    device a kernel starts microseconds after its launch, so the host and device
    clocks' alignment error shows here as well as a wrong pairing)."""
    launch = {e.id: e.time_range.start for e in events
              if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(LAUNCH_CALLS)}
    launch_us = np.array([launch.get(k.id, np.nan) for k in kernels], np.float64)
    starts = np.array([k.time_range.start for k in kernels], np.float64)
    found = ~np.isnan(launch_us)
    return launch_us, {"found": int(found.sum()), "after_kernel_start": int((launch_us[found] > starts[found]).sum())}


def profile_run(cfg, world, pairs, depth: int, args, trace_dir) -> dict:
    """One system at `depth` over the frames: warm, a window on the host clock,
    a window under the profiler."""
    system = SlamSystem(cfg, sensor="stereo", sync_every=args.sync, device=pairs[0].device)
    system.tracker.pipeline_depth = depth

    def run(lo, hi):
        before = _timer_totals(system.tracker.timers)
        kfs = system.arena.num_kfs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in range(lo, hi):
            system.track_stereo_device(pairs[f], world.timestamps[f])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = _timer_totals(system.tracker.timers)
        return {"frames": hi - lo, "wall_ms": wall * 1e3, "frames_per_s": (hi - lo) / wall,
                "keyframes": system.arena.num_kfs - kfs,
                "timers_ms": {k: round(v - before.get(k, 0.0), 2) for k, v in after.items()}}

    run(0, args.warm)
    plain = run(args.warm, args.warm + args.window)
    observability.start_trace(trace_dir)
    profiled = run(args.warm + args.window, args.warm + 2 * args.window)
    events = observability.stop_trace().events()
    # device-side events that are kernels: not copies, and not the tracker's
    # `trace_span` ranges, which the profiler mirrors onto the device timeline
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset", "tracker/"))
               and not getattr(e, "is_user_annotation", False)]
    spans = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("tracker/")]
    launch_us, launches = kernel_launches(events, kernels)
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name[:60]] += _device_us(e)
    kernel_ms = sum(_device_us(e) for e in kernels) / 1e3
    return {
        "card": cuda_timing.card_line(), "lost": sum(1 for r in system.tracker.records if r.lost),
        "pipeline_depth": depth, "depth_in_windows": system.tracker._current_depth(),
        "unprofiled_window": plain, "profiled_window": profiled,
        "spans": span_overlap(spans, kernels, launch_us), "launches": launches,
        "kernels": len(kernels), "kernels_per_frame": len(kernels) / args.window,
        "kernel_ms": kernel_ms, "kernel_ms_per_frame": kernel_ms / args.window,
        "busy_share_vs_unprofiled_wall": kernel_ms / plain["wall_ms"],
        "busy_share_under_profiler": kernel_ms / profiled["wall_ms"],
        "top_kernels_ms": {k: round(v / 1e3, 2) for k, v in by_name.most_common(12)},
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warm", type=int, default=81)
    ap.add_argument("--window", type=int, default=24)
    ap.add_argument("--sync", type=int, default=8)
    ap.add_argument("--depth", type=int, nargs="+", default=[2],
                    help="the tracker's pipeline depth (1: serial); several values run in turns on the same frames")
    ap.add_argument("--trace", default=None, help="DIR: write each profiled window's Chrome trace under DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path needs a CUDA device")

    dev = torch.device("cuda", 0)
    cfg = SlamConfig()
    world = bench_world(cfg)
    n = args.warm + 2 * args.window
    pairs = [torch.from_numpy(np.stack(world.stereo_pair(f))).to(dev) for f in range(n)]
    for i, depth in enumerate(args.depth):
        trace_dir = None if args.trace is None else os.path.join(args.trace, f"run{i}_depth{depth}")
        print(json.dumps(profile_run(cfg, world, pairs, depth, args, trace_dir)), flush=True)


if __name__ == "__main__":
    main()
