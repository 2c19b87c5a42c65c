"""Device busy share of the main path (tracker + local mapper) on one CUDA device.

    python -m slam_framework_torch.tools.profile_main_path [--warm 81] [--window 24]

Tracks the bench world at `SlamConfig()` defaults through `track_stereo_device`:
`--warm` frames first (the map grows past its bootstrap), then one window of
`--window` frames on the host clock alone, then a second window under
`torch.profiler`. Prints one JSON line: per window the wall time, the
keyframes made and the stage timers' share; from the profiled window the
number of kernels, their summed device time and the largest entries by name.
The busy share is kernel time of the profiled window over the wall time of
the unprofiled one (the profiler slows the host, which is the bottleneck).
Needs a CUDA device; it does not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import time

import numpy as np
import torch

from slam_framework_torch.config import SlamConfig
from slam_framework_torch.system import SlamSystem
from slam_framework_torch.tools.track_bench_world import bench_world
from slam_framework_torch.utils import cuda_timing


def _timer_totals(timers) -> dict:
    return {k: v["total_ms"] for k, v in timers.summary().items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warm", type=int, default=81)
    ap.add_argument("--window", type=int, default=24)
    ap.add_argument("--sync", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    cfg = SlamConfig()
    world = bench_world(cfg)
    n = args.warm + 2 * args.window
    pairs = [torch.from_numpy(np.stack(world.stereo_pair(f))).to(dev) for f in range(n)]
    system = SlamSystem(cfg, sensor="stereo", sync_every=args.sync, device=dev)

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
        return {"frames": hi - lo, "wall_ms": wall * 1e3, "keyframes": system.arena.num_kfs - kfs,
                "timers_ms": {k: round(v - before.get(k, 0.0), 2) for k, v in after.items()}}

    run(0, args.warm)
    plain = run(args.warm, args.warm + args.window)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled = run(args.warm + args.window, n)
    # device-side events that are kernels: not copies, and not the tracker's
    # `trace_span` ranges, which the profiler mirrors onto the device timeline
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset", "tracker/"))
               and not getattr(e, "is_user_annotation", False)]

    def device_us(e):  # the attribute was renamed between PyTorch versions
        return e.device_time if hasattr(e, "device_time") else e.cuda_time

    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name[:60]] += device_us(e)
    kernel_ms = sum(device_us(e) for e in kernels) / 1e3
    lost = sum(1 for r in system.tracker.records if r.lost)
    print(json.dumps({
        "card": cuda_timing.card_line(), "lost": lost,
        "unprofiled_window": plain, "profiled_window": profiled,
        "kernels": len(kernels), "kernels_per_frame": len(kernels) / args.window,
        "kernel_ms": kernel_ms, "kernel_ms_per_frame": kernel_ms / args.window,
        "busy_share_vs_unprofiled_wall": kernel_ms / plain["wall_ms"],
        "busy_share_under_profiler": kernel_ms / profiled["wall_ms"],
        "top_kernels_ms": {k: round(v / 1e3, 2) for k, v in by_name.most_common(12)},
    }), flush=True)


if __name__ == "__main__":
    main()
