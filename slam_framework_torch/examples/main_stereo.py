"""Stereo KITTI runner of the port — examples/main_stereo.py on slam_framework_torch
(reference: examples/main_stereo.cpp): load config + sequence, feed every stereo
pair through the system, save the KITTI-format trajectory, report timing and (when
ground truth is present) ATE.

Usage:
    python -m slam_framework_torch.examples.main_stereo CONFIG_JSON SEQUENCE_DIR
        [--out positions.txt] [--gt-root DATASET_ROOT --seq 00] [--max-frames N]
        [--pace] [--device cuda]

`--pace` throttles to the sensor rate (sleeping on the sequence's timestamps).
`--device` is where the system runs: the first CUDA device unless `cpu` is given;
without a CUDA device the default raises. The last line of the output is one JSON
object: frames, keyframes, map_points, loops_closed, fps, median_track_ms,
trajectory and, with ground truth, ate_rmse_m.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from slam_framework_torch import resolve_device
from slam_framework_torch.config import SlamConfig
from slam_framework_torch.io import kitti, trajectory
from slam_framework_torch.system import SlamSystem


def add_device_argument(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda", help="cuda (default), cuda:1 ... or cpu")


def device_of(name: str):
    """The runner's device: a CUDA name needs a CUDA device (never the CPU instead)."""
    return resolve_device(None if name == "cuda" else name)


def track_sequence(cfg: SlamConfig, seq: kitti.KittiSequence, device, out: str, *, max_frames: int = 0,
                   pace: bool = False, gt=None):
    """Feed the sequence's stereo pairs (all, or the first `max_frames`) through a
    new SlamSystem on `device`, save its KITTI-format trajectory to `out`, and
    return the shut-down system and the runner's report. `gt` is the ground truth
    as `kitti.load_ground_truth` gives it; with it the report holds ate_rmse_m."""
    n = min(len(seq), max_frames) if max_frames else len(seq)
    system = SlamSystem(cfg, device=device)
    times = []
    t_wall0 = time.perf_counter()
    for f in range(n):
        left, right = seq.stereo_pair(f)
        t0 = time.perf_counter()
        system.track_stereo(left, right, float(seq.timestamps[f]))
        times.append(time.perf_counter() - t0)
        if pace and f + 1 < n:
            ahead = float(seq.timestamps[f + 1]) - (time.perf_counter() - t_wall0)
            if ahead > 0:
                time.sleep(ahead)
        if f % 100 == 0:
            print(f"frame {f}/{n}  state={system.tracking_state.name}")
    stats = system.shutdown()
    wall = time.perf_counter() - t_wall0

    system.save_trajectory_kitti(out)
    med = float(np.median(times))
    report = {
        "frames": stats["frames"], "keyframes": stats["keyframes"],
        "map_points": stats["map_points"], "loops_closed": stats["loops_closed"],
        "fps": round(stats["frames"] / wall, 2),
        "median_track_ms": round(med * 1e3, 2),
        "trajectory": out,
    }
    if gt is not None:
        est = system.frame_poses()
        m = min(len(est), len(gt))
        report["ate_rmse_m"] = round(
            float(trajectory.ate_rmse(est[:m], np.linalg.inv(gt[:m]), align="se3")), 4
        )
    return system, report


def run(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config")
    ap.add_argument("sequence_dir")
    ap.add_argument("--out", default="positions.txt")
    ap.add_argument("--gt-root", default=None, help="dataset root holding ground_truth_poses/")
    ap.add_argument("--seq", default=None, help="sequence id for ground truth, e.g. 00")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--pace", action="store_true", help="throttle to sensor timestamps")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    device = device_of(args.device)
    cfg = SlamConfig.from_json(args.config, sensor="stereo")
    seq = kitti.load_sequence(args.sequence_dir)
    n = min(len(seq), args.max_frames) if args.max_frames else len(seq)
    print(f"sequence: {args.sequence_dir} ({n} frames)")
    gt = kitti.load_ground_truth(args.gt_root, args.seq) if args.gt_root and args.seq else None
    _, report = track_sequence(cfg, seq, device, args.out, max_frames=args.max_frames, pace=args.pace, gt=gt)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(run())
