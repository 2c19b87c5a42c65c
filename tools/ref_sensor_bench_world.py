"""Run the bench world through the JAX reference `SlamSystem` as an RGB-D or a
monocular sensor, on the pixels the PyTorch port renders, and print what came
out: the yardstick for the port's runs of the same frames
(`python -m slam_framework_torch.tools.track_bench_world --sensor rgbd|monocular`)
and for `chip_smoke.py`'s phases 9 and 10.

    JAX_PLATFORMS=cpu python tools/ref_sensor_bench_world.py --sensor rgbd --frames 330
    JAX_PLATFORMS=cpu python tools/ref_sensor_bench_world.py --sensor monocular --frames 330

The world is bench.py's (seed 3, speed 1.0, yaw 2*pi/300, 22,000 landmarks) at
`SlamConfig(sensor=...)` defaults, `sync_every=8`. RGB-D is fed the left image and
its ray-cast depth (`rgbd_pair`), monocular the left image alone (the world of
`tools/bench_mono.py`). Prints one JSON line: the frames without a tracked pose,
the lost records, the first tracked frame (for monocular the two-view
initialization's frame and the map's median depth just after it), keyframes,
loops closed, resets, and the ATE over the tracked frames (SE3-aligned for RGB-D,
Sim3-aligned for monocular, whose scale is free), also over the longest run of
consecutive tracked frames from the first one.
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
from slam_framework_tpu.pipeline.mono_tracker import MonoTracker  # noqa: E402
from slam_framework_tpu.system import SlamSystem  # noqa: E402
from slam_framework_torch.config import SlamConfig as PortConfig  # noqa: E402
from slam_framework_torch.tools.track_bench_world import bench_world  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sensor", choices=("rgbd", "monocular"), required=True)
    ap.add_argument("--frames", type=int, default=330)
    ap.add_argument("--sync", type=int, default=8)
    args = ap.parse_args()
    world = bench_world(PortConfig(), num_frames=max(args.frames, 330))
    inits = []
    create = MonoTracker._create_initial_map

    def recording(self, *a, **k):
        ok = create(self, *a, **k)
        if ok:
            arena = self.arena
            pids = np.nonzero(arena.pt_valid[: arena.num_pts])[0]
            T1 = arena.kf_pose[0]
            z = arena.pt_pos[pids] @ T1[:3, :3].T[:, 2] + T1[2, 3]
            inits.append({"frame": int(self.frame_id), "ref_frame": int(self.records[0].frame_id),
                          "points": int(len(pids)), "median_depth": float(np.median(z))})
        return ok

    MonoTracker._create_initial_map = recording
    system = SlamSystem(SlamConfig(sensor=args.sensor), sync_every=args.sync)
    t0 = time.perf_counter()
    for f in range(args.frames):
        if args.sensor == "rgbd":
            system.track_rgbd(*world.rgbd_pair(f), world.timestamps[f])
        else:
            system.track_monocular(world.render(f), world.timestamps[f])
    stats = system.shutdown()
    wall = time.perf_counter() - t0
    records = system.tracker.records
    tracked = [i for i, r in enumerate(records) if not r.lost]
    fids = [records[i].frame_id for i in tracked]
    align = "se3" if args.sensor == "rgbd" else "sim3"
    poses = system.frame_poses()
    ate = trajectory.ate_rmse(poses[tracked], world.poses[fids], align=align) if len(tracked) > 2 else None
    # the longest run of consecutive tracked frames from the first tracked one
    run = 0
    while run < len(fids) and fids[run] == fids[0] + run:
        run += 1
    ate_run = (trajectory.ate_rmse(poses[tracked[:run]], world.poses[fids[:run]], align=align)
               if run > 2 else None)
    closer = system.loop_closer
    print(json.dumps({
        "package": "slam_framework_tpu on the CPU", "sensor": args.sensor, "frames": args.frames,
        "sync_every": args.sync, "wall_s_with_rendering": wall,
        "untracked": args.frames - len(tracked),
        "lost": sum(1 for r in records if r.lost),
        "lost_frames": [r.frame_id for r in records if r.lost],
        "first_tracked_frame": fids[0] if fids else None,
        "tracked_prefix": [fids[0], fids[run - 1]] if run else None,
        "inits": inits,
        "ate_m": ate, "align": align, "ate_prefix_m": ate_run,
        "stats": stats,
        "loop_edges": [(int(x), int(y)) for x, y, _ in closer.loop_edges] if closer else [],
        "n_sim3_attempts": closer.n_sim3_attempts if closer else 0,
        "last_report": closer.last_report if closer else {},
    }, default=float), flush=True)


if __name__ == "__main__":
    main()
