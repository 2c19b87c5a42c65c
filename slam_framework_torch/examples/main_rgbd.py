"""RGB-D runner of the port — examples/main_rgbd.py on slam_framework_torch
(reference: src/slam_system.cpp:131-172 TrackRGBD; the reference ships no RGB-D
example binary, only the entry point — this runner completes that surface).

Two input modes:
  - A TUM-style directory with `rgb/` + `depth/` subdirectories and matching
    sorted filenames: colour read as grey (io/png.imread_gray), depth as its
    16-bit samples (io/png.imread_unchanged) divided by `camera.depth_map_factor`.
  - `--synthetic N`: an N-frame ray-cast synthetic world with exact ground
    truth (io/synthetic.py) — runs without any dataset and reports ATE.

Usage:
    python -m slam_framework_torch.examples.main_rgbd CONFIG_JSON SEQUENCE_DIR [--out traj.txt]
    python -m slam_framework_torch.examples.main_rgbd --synthetic 60 [--out traj.txt] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
import time

import numpy as np

from slam_framework_torch.config import SlamConfig
from slam_framework_torch.examples.main_stereo import add_device_argument, device_of
from slam_framework_torch.io import synthetic, trajectory
from slam_framework_torch.io.png import imread_gray, imread_unchanged
from slam_framework_torch.system import SlamSystem


def _load_tum_dir(seq_dir: str, depth_factor: float):
    """Yield (gray, depth_m, timestamp) from rgb/ + depth/ file pairs."""
    rgbs = sorted(glob.glob(os.path.join(seq_dir, "rgb", "*")))
    depths = sorted(glob.glob(os.path.join(seq_dir, "depth", "*")))
    n = min(len(rgbs), len(depths))
    for f in range(n):
        gray = imread_gray(rgbs[f])
        d_raw = imread_unchanged(depths[f]).astype(np.float32)
        depth = d_raw / depth_factor if depth_factor > 0 else d_raw
        yield gray, depth, float(f)


def run(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config", nargs="?", default=None)
    ap.add_argument("sequence_dir", nargs="?", default=None)
    ap.add_argument("--synthetic", type=int, default=0,
                    help="run an N-frame synthetic RGB-D world instead of files")
    ap.add_argument("--out", default="positions_rgbd.txt")
    ap.add_argument("--max-frames", type=int, default=0)
    add_device_argument(ap)
    args = ap.parse_args(argv)

    device = device_of(args.device)
    world = None
    if args.synthetic:
        cfg = SlamConfig(sensor="rgbd")
        cfg = dataclasses.replace(
            cfg, camera=dataclasses.replace(cfg.camera, width=640, height=240,
                                            cx=320.0, cy=120.0),
        )
        world = synthetic.make_world(num_frames=args.synthetic, cam=cfg.camera,
                                     seed=1, speed=0.8, yaw_rate=0.004)
        frames = ((*world.rgbd_pair(f), float(world.timestamps[f]))
                  for f in range(world.num_frames))
        n = world.num_frames
    else:
        if not (args.config and args.sequence_dir):
            ap.error("CONFIG_JSON and SEQUENCE_DIR required unless --synthetic")
        cfg = SlamConfig.from_json(args.config, sensor="rgbd")
        frames = _load_tum_dir(args.sequence_dir, cfg.camera.depth_map_factor)
        n = None

    system = SlamSystem(cfg, device=device)
    times = []
    t_wall0 = time.perf_counter()
    for f, (gray, depth, ts) in enumerate(frames):
        if args.max_frames and f >= args.max_frames:
            break
        t0 = time.perf_counter()
        system.track_rgbd(gray, depth, ts)
        times.append(time.perf_counter() - t0)
        if f % 100 == 0:
            print(f"frame {f}{f'/{n}' if n else ''}  state={system.tracking_state.name}")
    stats = system.shutdown()
    wall = time.perf_counter() - t_wall0

    system.save_trajectory_kitti(args.out)
    report = {
        "frames": stats["frames"], "keyframes": stats["keyframes"],
        "map_points": stats["map_points"], "loops_closed": stats["loops_closed"],
        "fps": round(stats["frames"] / wall, 2),
        "median_track_ms": round(float(np.median(times)) * 1e3, 2),
        "trajectory": args.out,
    }
    if world is not None:
        est = system.frame_poses()
        m = min(len(est), len(world.poses))
        report["ate_rmse_m"] = round(
            float(trajectory.ate_rmse(est[:m], world.poses[:m], align="se3")), 4
        )
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(run())
