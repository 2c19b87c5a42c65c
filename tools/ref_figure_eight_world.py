"""Run the figure-eight world through the JAX reference `SlamSystem` (tracker, local
mapper, place recognition, loop closer, global BA) on the pixels the PyTorch port
renders, and print what came out: the yardstick for the port's run of the same
frames (`python -m slam_framework_torch.tools.track_bench_world --world figure8`).

    JAX_PLATFORMS=cpu python tools/ref_figure_eight_world.py [--geometry multi-loop] [--sync 8]

The world is the reference test's two-loop circuit (`make_figure_eight_world`,
seed 4, speed 1.0, `lap_frames=200`: 450 frames, one lap around circle A, one
around the tangent circle B, back onto A) at `SlamConfig()` defaults (1241x376,
2000 features, 8 levels, default capacities) or, with `--geometry multi-loop`,
at the configuration of the reference's TestMultiLoop (640x240, 800 features, 4
levels, 192 keyframes), rendered by the port. Prints one
JSON line: ATE against ground truth (SE3-aligned), lost frames, keyframes, map
points, loops closed and the frame at which each closed, the loop edges, the loop
closer's last report and its number of Sim3 attempts.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

from slam_framework_tpu.config import CameraConfig, CapacityConfig, OrbConfig, SlamConfig  # noqa: E402
from slam_framework_tpu.io import trajectory  # noqa: E402
from slam_framework_tpu.system import SlamSystem  # noqa: E402
from slam_framework_torch.config import SlamConfig as PortConfig  # noqa: E402
from slam_framework_torch.tools.track_bench_world import figure_eight_world, multi_loop_config  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=0, help="frames to track (default: all 450)")
    ap.add_argument("--sync", type=int, default=8)
    ap.add_argument("--geometry", default="kitti", choices=("kitti", "multi-loop"))
    args = ap.parse_args()
    if args.geometry == "kitti":
        port_cfg, cfg = PortConfig(), SlamConfig()
    else:
        port_cfg = multi_loop_config()
        cfg = SlamConfig(camera=CameraConfig(**dataclasses.asdict(port_cfg.camera)),
                         orb=OrbConfig(**dataclasses.asdict(port_cfg.orb)),
                         capacity=CapacityConfig(**dataclasses.asdict(port_cfg.capacity)))
    world = figure_eight_world(port_cfg)
    n = args.frames or world.num_frames
    system = SlamSystem(cfg, sync_every=args.sync)
    closer = system.loop_closer
    loops_at = []
    t0 = time.perf_counter()
    for f in range(n):
        system.track_stereo(*world.stereo_pair(f), world.timestamps[f])
        if closer.n_loops_closed > len(loops_at):
            loops_at.append(f)
    stats = system.shutdown()
    wall = time.perf_counter() - t0
    records = system.tracker.records
    est = system.frame_poses()
    gt = world.poses[[r.frame_id for r in records]]
    print(json.dumps({
        "package": "slam_framework_tpu on the CPU", "world": "figure8", "geometry": args.geometry, "frames": n, "sync_every": args.sync,
        "wall_s_with_rendering": wall,
        "ate_m": trajectory.ate_rmse(est, gt, align="se3"),
        "lost": sum(1 for r in records if r.lost),
        "lost_frames": [r.frame_id for r in records if r.lost],
        "stats": stats,
        "loops_at_frames": loops_at,
        "loop_edges": [(int(a), int(b)) for a, b, _ in closer.loop_edges],
        "n_sim3_attempts": closer.n_sim3_attempts,
        "last_report": closer.last_report,
    }, default=float), flush=True)


if __name__ == "__main__":
    main()
