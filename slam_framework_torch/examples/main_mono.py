"""Monocular KITTI runner of the port — examples/main_mono.py on slam_framework_torch
(reference: examples/main_mono.cpp): left images only, keyframe trajectory export,
Sim3-aligned ATE when ground truth is present (monocular scale is gauge-free).

Usage:
    python -m slam_framework_torch.examples.main_mono CONFIG_JSON SEQUENCE_DIR
        [--out keyframes.txt] [--gt-root DATASET_ROOT --seq 00] [--max-frames N]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from slam_framework_torch.config import SlamConfig
from slam_framework_torch.examples.main_stereo import add_device_argument, device_of
from slam_framework_torch.io import kitti, trajectory
from slam_framework_torch.system import SlamSystem


def run(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config")
    ap.add_argument("sequence_dir")
    ap.add_argument("--out", default="keyframes.txt")
    ap.add_argument("--gt-root", default=None)
    ap.add_argument("--seq", default=None)
    ap.add_argument("--max-frames", type=int, default=0)
    add_device_argument(ap)
    args = ap.parse_args(argv)

    device = device_of(args.device)
    cfg = SlamConfig.from_json(args.config, sensor="monocular")
    seq = kitti.load_sequence(args.sequence_dir)
    n = min(len(seq), args.max_frames) if args.max_frames else len(seq)
    print(f"sequence: {args.sequence_dir} ({n} frames, monocular)")

    system = SlamSystem(cfg, device=device)
    t_wall0 = time.perf_counter()
    for f in range(n):
        system.track_monocular(seq.mono(f), float(seq.timestamps[f]))
        if f % 100 == 0:
            print(f"frame {f}/{n}  state={system.tracking_state.name}")
    stats = system.shutdown()
    wall = time.perf_counter() - t_wall0

    system.save_keyframe_trajectory(args.out)
    report = {
        "frames": stats["frames"], "keyframes": stats["keyframes"],
        "map_points": stats["map_points"], "loops_closed": stats["loops_closed"],
        "fps": round(stats["frames"] / wall, 2),
        "trajectory": args.out,
    }
    if args.gt_root and args.seq:
        gt = kitti.load_ground_truth(args.gt_root, args.seq)
        if gt is not None:
            est = system.frame_poses()
            m = min(len(est), len(gt))
            report["ate_rmse_sim3_m"] = round(
                float(trajectory.ate_rmse(est[:m], np.linalg.inv(gt[:m]), align="sim3")), 4
            )
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(run())
