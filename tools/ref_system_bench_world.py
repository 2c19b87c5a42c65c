"""Run the bench world through the JAX reference `SlamSystem` (tracker, local mapper,
place recognition, loop closer, global BA) on the pixels the PyTorch port renders,
and print what came out: the yardstick for the port's full-system run of the same
frames (`python -m slam_framework_torch.tools.track_bench_world --frames 330`).

    JAX_PLATFORMS=cpu python tools/ref_system_bench_world.py --frames 330

The world is bench.py's (seed 3, speed 1.0, yaw 2*pi/300, 22,000 landmarks) at
`SlamConfig()` defaults, rendered for `--world-frames` frames (the camera path does
not depend on that number). Prints one JSON line: ATE against ground truth
(SE3-aligned), lost frames, keyframes, map points, loops closed, the keyframe at
which the loop closed and its loop keyframe, the loop closer's last report and its
number of Sim3 attempts.
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
from slam_framework_tpu.system import SlamSystem  # noqa: E402
from slam_framework_torch.config import SlamConfig as PortConfig  # noqa: E402
from slam_framework_torch.tools.track_bench_world import bench_world  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=330)
    ap.add_argument("--world-frames", type=int, default=0, help="frames the world is made for (default: --frames, at least 330)")
    ap.add_argument("--sync", type=int, default=8)
    args = ap.parse_args()
    world = bench_world(PortConfig(), num_frames=max(args.world_frames or args.frames, 330))
    system = SlamSystem(SlamConfig(), sync_every=args.sync)
    t0 = time.perf_counter()
    for f in range(args.frames):
        system.track_stereo(*world.stereo_pair(f), world.timestamps[f])
    stats = system.shutdown()
    wall = time.perf_counter() - t0
    records = system.tracker.records
    closer = system.loop_closer
    print(json.dumps({
        "package": "slam_framework_tpu on the CPU", "frames": args.frames, "sync_every": args.sync,
        "wall_s_with_rendering": wall,
        "ate_m": trajectory.ate_rmse(system.frame_poses(), world.poses[: args.frames], align="se3"),
        "lost": sum(1 for r in records if r.lost),
        "first_lost_frame": next((r.frame_id for r in records if r.lost), None),
        "stats": stats,
        "closed_at_kf": int(closer.last_loop_kf) if closer.n_loops_closed else None,
        "loop_edges": [(int(a), int(b)) for a, b, _ in closer.loop_edges],
        "n_sim3_attempts": closer.n_sim3_attempts,
        "last_report": closer.last_report,
        "cap_clips": {**system.tracker.local_mapper.cap_clips, **closer.cap_clips},
    }, default=float), flush=True)


if __name__ == "__main__":
    main()
