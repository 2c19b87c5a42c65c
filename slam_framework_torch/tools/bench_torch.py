"""The port on bench.py's workload: one JSON line with bench.py's keys.

    python -m slam_framework_torch.tools.bench_torch            # first CUDA device
    python -m slam_framework_torch.tools.bench_torch --device cpu --frames 40

Workload (bench.py): the 330-frame loopy synthetic sequence at KITTI stereo
geometry (1241x376, 2000 ORB features, 8 levels, `SlamConfig()` defaults, world
seed 3, speed 1.0, yaw 2*pi/300, 22,000 landmarks, `sync_every=8`) through the
COMPLETE SlamSystem: tracking, local mapping, place recognition, loop closing
with the essential graph and the asynchronous global BA. The circle closes, so
the loop closer must fire. As in bench.py the pairs are rendered and staged on
the device before the timed loop and fed through `track_stereo_device`; the
wall clock covers every frame and the tail flush, and `shutdown()` (the final
merges) is outside it. PyTorch compiles nothing, so the untimed warm-up is one
chunk of a throwaway system (it loads the CUDA modules and builds the kernel),
not a whole lap.

Prints {"metric", "value", "unit", "vs_baseline", "ate_m", "frames",
"lost_frames", "loops_closed", "keyframes"} and "device" (the card's name,
or "cpu": a CPU run's rate says nothing about the card): frames/s on the host
clock, frames/s over the 10 fps sensor rate, and the SE3-aligned ATE of the
final per-frame trajectory against ground truth. `--blackout A-B` blanks
frames A..B (a uniform gray pair) so the relocalizer must recover tracking;
the line then adds the relocalized frame and the ATE over tracked frames.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from slam_framework_torch import resolve_device
from slam_framework_torch.config import SlamConfig
from slam_framework_torch.io import trajectory
from slam_framework_torch.system import SlamSystem
from slam_framework_torch.tools.track_bench_world import (
    bench_world, blackout_summary, frame_pair, parse_blackout)


WARM_FRAMES = 9  # the initial frame + one chunk of 8


def run(n_frames: int = 330, device=None, sync: int = 8, blackout: str = "") -> dict:
    device = resolve_device(device)
    cfg = SlamConfig()
    world = bench_world(cfg, num_frames=max(n_frames, 330))
    blank = parse_blackout(blackout)
    pairs = [torch.from_numpy(np.stack(frame_pair(world, f, blank))).to(device) for f in range(n_frames)]

    def sync_device():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync_device()
    warm = SlamSystem(cfg, sync_every=sync, device=device)
    for f in range(min(WARM_FRAMES, n_frames)):
        warm.track_stereo_device(pairs[f], world.timestamps[f])
    warm.shutdown()
    del warm

    system = SlamSystem(cfg, sync_every=sync, device=device)
    sync_device()
    t0 = time.perf_counter()
    for f, pair in enumerate(pairs):
        system.track_stereo_device(pair, world.timestamps[f])
    system.tracker.flush()
    sync_device()
    wall = time.perf_counter() - t0
    stats = system.shutdown()  # final merges, untimed as in bench.py

    est = system.frame_poses()
    fps = n_frames / wall
    extra = {}
    if blank:
        summary = blackout_summary(system, world, blank)
        extra = {k: summary[k] for k in ("blackout", "relocalized_frame", "ate_tracked_m")}
    return {
        "metric": "stereo_tracked_frames_per_sec",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / 10.0, 2),
        "ate_m": round(float(trajectory.ate_rmse(est, world.poses[: len(est)], align="se3")), 4),
        "frames": n_frames,
        "lost_frames": sum(1 for r in system.tracker.records if r.lost),
        "loops_closed": stats.get("loops_closed", 0),
        "keyframes": stats.get("keyframes", 0),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        **extra,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=330)
    ap.add_argument("--sync", type=int, default=8)
    ap.add_argument("--device", default=None, help="cpu, cuda, cuda:1 ... (default: the first CUDA device)")
    ap.add_argument("--blackout", default="", help="A-B: frames A..B (inclusive) become a blank gray pair")
    args = ap.parse_args()
    print(json.dumps(run(args.frames, args.device, args.sync, args.blackout)), flush=True)


if __name__ == "__main__":
    main()
