"""Track the bench world with the port's stereo SlamSystem and print what came out.

    python -m slam_framework_torch.tools.track_bench_world --frames 329 --device cpu

The world is bench.py's (seed 3, speed 1.0, yaw 2*pi/300, 22,000 landmarks) at
`SlamConfig()` defaults (1241x376, 2000 features, 8 levels, default
capacities). Prints one JSON line: frames/s on the host clock, ATE against
ground truth (SE3-aligned), lost frames, keyframes, map points, the mapper's
totals and the stage timers. `chip_smoke.py`'s ATE bound is twice the ATE this
prints on the CPU over the same frames. `--threads` caps torch's CPU threads.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from slam_framework_torch.config import SlamConfig
from slam_framework_torch.io import synthetic, trajectory
from slam_framework_torch.system import SlamSystem


def bench_world(cfg: SlamConfig, num_frames: int = 330):
    return synthetic.make_world(
        num_frames=num_frames, cam=cfg.camera, seed=3, speed=1.0,
        yaw_rate=2.0 * np.pi / 300.0, num_landmarks=22000,
    )


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=329)
    ap.add_argument("--sync", type=int, default=8)
    ap.add_argument("--device", default=None, help="cpu, cuda, cuda:1 ... (default: the first CUDA device)")
    ap.add_argument("--threads", type=int, default=0)
    args = ap.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)

    cfg = SlamConfig()
    world = bench_world(cfg)
    system = SlamSystem(cfg, sensor="stereo", sync_every=args.sync, device=args.device)
    t0 = time.perf_counter()
    for f in range(args.frames):
        system.track_stereo(*world.stereo_pair(f), world.timestamps[f])
    stats = system.shutdown()
    wall = time.perf_counter() - t0
    est = system.frame_poses()
    records = system.tracker.records
    print(json.dumps({
        "device": str(system.device), "frames": args.frames, "sync_every": args.sync,
        "wall_s_with_rendering": wall, "frames_per_s_with_rendering": args.frames / wall,
        "ate_m": trajectory.ate_rmse(est, world.poses[: args.frames], align="se3"),
        "lost": sum(1 for r in records if r.lost),
        "first_lost_frame": next((r.frame_id for r in records if r.lost), None),
        "stats": stats,
        "timers": system.tracker.timers.summary(),
    }), flush=True)


if __name__ == "__main__":
    main()
