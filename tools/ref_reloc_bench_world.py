"""Run the bench world with a blackout through the JAX reference `SlamSystem` on the
pixels the PyTorch port renders, and print what came out: the yardstick for the
port's blackout run of the same frames
(`python -m slam_framework_torch.tools.track_bench_world --frames 330 --blackout 110-112`).

    JAX_PLATFORMS=cpu python tools/ref_reloc_bench_world.py --frames 330 --blackout 110-112

The world is bench.py's (seed 3, speed 1.0, yaw 2*pi/300, 22,000 landmarks) at
`SlamConfig()` defaults. Frames A..B of `--blackout A-B` (inclusive) are replaced by
a uniform gray (90) pair, so tracking is lost there and the relocalizer has to
recover it. Prints one JSON line: lost frames, the first frame tracked again after
the blackout with its relocalization event (candidate keyframe, inliers), loops
closed, keyframes, resets and the ATE over the tracked frames (SE3-aligned).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

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
    ap.add_argument("--sync", type=int, default=8)
    ap.add_argument("--blackout", default="110-112", help="first-last blank frame, inclusive")
    args = ap.parse_args()
    a, b = (int(x) for x in args.blackout.split("-"))
    world = bench_world(PortConfig(), num_frames=max(args.frames, 330))
    system = SlamSystem(SlamConfig(), sync_every=args.sync)
    blank = np.full_like(world.stereo_pair(0)[0], 90)
    t0 = time.perf_counter()
    for f in range(args.frames):
        pair = (blank, blank) if a <= f <= b else world.stereo_pair(f)
        system.track_stereo(*pair, world.timestamps[f])
    stats = system.shutdown()
    wall = time.perf_counter() - t0
    records = system.tracker.records
    lost = [r.frame_id for r in records if r.lost]
    tracked = [i for i, r in enumerate(records) if not r.lost]
    est = system.frame_poses()[tracked]
    reloc = [e for e in system.tracker.metrics.records if e.get("relocalized")]
    closer = system.loop_closer
    print(json.dumps({
        "package": "slam_framework_tpu on the CPU", "frames": args.frames, "sync_every": args.sync,
        "blackout": [a, b], "wall_s_with_rendering": wall,
        "lost": len(lost), "lost_frames": lost,
        "relocalized_frame": next((r.frame_id for r in records if not r.lost and r.frame_id > b), None),
        "relocalized_against_kf": next((r.ref_kf for r in records if not r.lost and r.frame_id > b), None),
        "reloc_events": reloc,
        "ate_tracked_m": trajectory.ate_rmse(est, world.poses[[records[i].frame_id for i in tracked]],
                                             align="se3"),
        "stats": stats,
        "loop_edges": [(int(x), int(y)) for x, y, _ in closer.loop_edges] if closer else [],
        "n_sim3_attempts": closer.n_sim3_attempts if closer else 0,
        "last_report": closer.last_report if closer else {},
    }, default=float), flush=True)


if __name__ == "__main__":
    main()
