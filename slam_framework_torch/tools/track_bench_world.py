"""Track the bench world with the port's stereo SlamSystem and print what came out.

    python -m slam_framework_torch.tools.track_bench_world --frames 330 --device cpu

The world is bench.py's (seed 3, speed 1.0, yaw 2*pi/300, 22,000 landmarks) at
`SlamConfig()` defaults (1241x376, 2000 features, 8 levels, default
capacities). The whole system runs: tracker, local mapper, place recognition
and loop closer (`--no-loop-closer` leaves the last two out). Prints one JSON
line: frames/s on the host clock, ATE against ground truth (SE3-aligned), lost
frames, keyframes, map points, loops closed, the loop closer's report and its
number of Sim3 attempts, the mapper's totals and the stage timers.
`chip_smoke.py`'s ATE bound is twice the ATE this prints on the CPU over the
same frames. `--threads` caps torch's CPU threads. `--blackout A-B` replaces
frames A..B (inclusive) by a uniform gray (90) pair, so tracking is lost there
and the relocalizer must recover it; the line then also carries the lost
frames, the frame tracked again after the blackout with its relocalization
event and the ATE over the tracked frames alone (`chip_smoke.py`'s phase 7
bound is twice that on the CPU).
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


def parse_blackout(text: str):
    """'A-B' -> range(A, B + 1); '' -> an empty range."""
    if not text:
        return range(0)
    a, b = (int(x) for x in text.split("-"))
    return range(a, b + 1)


def frame_pair(world, f: int, blackout):
    """World frame f's stereo pair, or a uniform gray (90) pair inside the blackout."""
    left, right = world.stereo_pair(f)
    if f in blackout:
        return np.full_like(left, 90), np.full_like(right, 90)
    return left, right


def blackout_summary(system: SlamSystem, world, blackout) -> dict:
    """Lost frames, the first frame tracked after the blackout with its
    relocalization event, and the ATE over the tracked frames."""
    records = system.tracker.records
    tracked = [i for i, r in enumerate(records) if not r.lost]
    est = system.frame_poses()[tracked]
    gt = world.poses[[records[i].frame_id for i in tracked]]
    after = [r for r in records if not r.lost and blackout and r.frame_id > blackout[-1]]
    return {
        "blackout": [blackout[0], blackout[-1]] if blackout else None,
        "lost_frames": [r.frame_id for r in records if r.lost],
        "relocalized_frame": after[0].frame_id if after else None,
        "relocalized_against_kf": after[0].ref_kf if after else None,
        "reloc_events": [e for e in system.tracker.metrics.records if e.get("relocalized")],
        "reloc_attempts": system.tracker.relocalizer.n_attempts if system.tracker.relocalizer else 0,
        "ate_tracked_m": trajectory.ate_rmse(est, gt, align="se3"),
    }


def loop_summary(system: SlamSystem) -> dict:
    """What the loop stage did: where it closed, its last report, its attempts."""
    closer = system.loop_closer
    if closer is None:
        return {"closed_at_kf": None, "loop_edges": [], "n_sim3_attempts": 0, "last_report": {}}
    return {
        "closed_at_kf": int(closer.last_loop_kf) if closer.n_loops_closed else None,
        "loop_edges": [(int(a), int(b)) for a, b, _ in closer.loop_edges],
        "n_sim3_attempts": closer.n_sim3_attempts,
        "last_report": closer.last_report,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=330)
    ap.add_argument("--sync", type=int, default=8)
    ap.add_argument("--device", default=None, help="cpu, cuda, cuda:1 ... (default: the first CUDA device)")
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--no-loop-closer", action="store_true", help="tracking and mapping alone")
    ap.add_argument("--blackout", default="", help="A-B: frames A..B (inclusive) become a blank gray pair")
    args = ap.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)

    cfg = SlamConfig()
    world = bench_world(cfg, num_frames=max(args.frames, 330))
    system = SlamSystem(cfg, sensor="stereo", sync_every=args.sync, device=args.device,
                        place_recognition=not args.no_loop_closer)
    blackout = parse_blackout(args.blackout)
    t0 = time.perf_counter()
    for f in range(args.frames):
        system.track_stereo(*frame_pair(world, f, blackout), world.timestamps[f])
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
        **loop_summary(system),
        **(blackout_summary(system, world, blackout) if blackout else {}),
        "timers": system.tracker.timers.summary(),
    }, default=float), flush=True)


if __name__ == "__main__":
    main()
