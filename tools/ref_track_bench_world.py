"""Track the bench world with the JAX reference `StereoTracker` (tracker + local
mapper, no `SlamSystem`, so no loop closer) on the pixels the PyTorch port renders,
and print what came out: the yardstick for the port's run of the same frames
(`python -m slam_framework_torch.tools.track_bench_world`).

    JAX_PLATFORMS=cpu python tools/ref_track_bench_world.py --frames 329 [--depth 2]

The world is bench.py's (seed 3, speed 1.0, yaw 2*pi/300, 22,000 landmarks) at
`SlamConfig()` defaults. Prints one JSON line: ATE against ground truth
(SE3-aligned), lost frames, keyframes, map points, BA aborts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

from slam_framework_tpu.config import SlamConfig  # noqa: E402
from slam_framework_tpu.io import trajectory  # noqa: E402
from slam_framework_tpu.pipeline.tracker import StereoTracker  # noqa: E402
from slam_framework_torch.config import SlamConfig as PortConfig  # noqa: E402
from slam_framework_torch.tools.track_bench_world import bench_world  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=329)
    ap.add_argument("--sync", type=int, default=8)
    ap.add_argument("--depth", type=int, default=2, help="the reference tracker's pipeline depth")
    args = ap.parse_args()
    world = bench_world(PortConfig())
    tracker = StereoTracker(SlamConfig(), sync_every=args.sync, pipeline_depth=args.depth)
    t0 = time.perf_counter()
    for f in range(args.frames):
        tracker.track(*world.stereo_pair(f), world.timestamps[f])
    tracker.flush()
    wall = time.perf_counter() - t0
    records = tracker.records
    arena, mapper = tracker.arena, tracker.local_mapper
    print(json.dumps({
        "package": "slam_framework_tpu on the CPU", "frames": args.frames, "sync_every": args.sync,
        "pipeline_depth": args.depth, "wall_s_with_rendering": wall,
        "ate_m": trajectory.ate_rmse(tracker.trajectory_poses(), world.poses[: args.frames], align="se3"),
        "lost": sum(1 for r in records if r.lost),
        "first_lost_frame": next((r.frame_id for r in records if r.lost), None),
        "keyframes": int(arena.n_valid_kfs), "keyframes_made": int(arena.num_kfs),
        "map_points": int(arena.n_valid_pts), "ba_aborts": mapper.ba_aborts, "cap_clips": dict(mapper.cap_clips),
    }), flush=True)


if __name__ == "__main__":
    main()
