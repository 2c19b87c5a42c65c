"""Track the bench world with the port's SlamSystem and print what came out.

    python -m slam_framework_torch.tools.track_bench_world --frames 330 --device cpu
    python -m slam_framework_torch.tools.track_bench_world --sensor rgbd --device cpu
    python -m slam_framework_torch.tools.track_bench_world --world figure8 --geometry multi-loop --sync 2 --device cpu

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
`--sensor rgbd` feeds the left image and its ray-cast depth (`rgbd_pair`),
`--sensor monocular` the left image alone (the world of tools/bench_mono.py); the
line then carries the frames without a tracked pose, the monocular
initialization and the ATE over the tracked frames, SE3-aligned for RGB-D and
Sim3-aligned for monocular, whose scale is free
(`tools/ref_sensor_bench_world.py` prints the reference's on the same pixels).
`--world figure8` tracks the figure-eight world instead (seed 4, speed 1.0,
`lap_frames=200`: 450 frames, two loop sites, `--frames` defaults to all of
them); the line then also carries the frame at which each loop closed and the
global BAs' outcomes.
`--geometry multi-loop` runs the reference's TestMultiLoop configuration
(`multi_loop_config`: 640x240, 800 features, 4 levels) in place of `SlamConfig()`;
`--world figure8 --geometry multi-loop` gives `chip_smoke.py`'s phase 11 bound
(`tools/ref_figure_eight_world.py` is the reference's run of the same pixels).
`--mesh N` hands the system a `LocalMesh(N)` on its device: the post-loop
global BA runs sharded over N ranks and point ownership migrates after the
merge; the line then carries the global BA's `devices` and the migration's
report (`chip_smoke.py` phase 13 is this run on the card):

    python -m slam_framework_torch.tools.track_bench_world --mesh 8
    python -m slam_framework_torch.tools.track_bench_world --mesh 8 --device cpu

`--depth D` sets the tracker's pipeline depth (default 2, the tracker's own:
depth 2 from 12 keyframes on; 1 is the serial order), as
`tools/ref_track_bench_world.py --depth` does for the reference:

    python -m slam_framework_torch.tools.track_bench_world --blackout 110-112 --depth 1 --device cpu
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from slam_framework_torch import resolve_device
from slam_framework_torch.config import CameraConfig, CapacityConfig, OrbConfig, SlamConfig
from slam_framework_torch.io import synthetic, trajectory
from slam_framework_torch.parallel import LocalMesh
from slam_framework_torch.system import SlamSystem


def bench_world(cfg: SlamConfig, num_frames: int = 330):
    return synthetic.make_world(
        num_frames=num_frames, cam=cfg.camera, seed=3, speed=1.0,
        yaw_rate=2.0 * np.pi / 300.0, num_landmarks=22000,
    )


def multi_loop_config() -> SlamConfig:
    """The configuration of the reference's TestMultiLoop (tests/test_system.py:16-28,
    339-345): 640x240, 800 features on 4 levels, 192 keyframes, 131,072 points."""
    return SlamConfig(
        camera=CameraConfig(fx=400.0, fy=400.0, cx=320.0, cy=120.0, width=640, height=240, fps=10.0, bf=400.0 * 0.54),
        orb=OrbConfig(num_features=800, num_levels=4),
        capacity=CapacityConfig(max_keyframes=192, max_map_points=131072, max_features=1024, local_window_points=8192),
    )


def figure_eight_world(cfg: SlamConfig):
    """The two-loop world of the reference's TestMultiLoop, at cfg's camera."""
    return synthetic.make_figure_eight_world(cam=cfg.camera, seed=4, speed=1.0, lap_frames=200)


def sensor_summary(system: SlamSystem, world, n_frames: int) -> dict:
    """Frames without a tracked pose, the lost records, the monocular
    initialization and the ATE over the tracked frames, aligned as the
    sensor's scale allows."""
    records = system.tracker.records
    tracked = [i for i, r in enumerate(records) if not r.lost]
    fids = [records[i].frame_id for i in tracked]
    align = "sim3" if system.cfg.sensor == "monocular" else "se3"
    est = system.frame_poses()[tracked]
    return {
        "untracked": n_frames - len(tracked),
        "lost_frames": [r.frame_id for r in records if r.lost],
        "first_tracked_frame": fids[0] if fids else None,
        "mono_init": getattr(system.tracker, "last_init", None),
        "align": align,
        "ate_tracked_m": trajectory.ate_rmse(est, world.poses[fids], align=align) if len(fids) > 2 else None,
    }


def feed(system: SlamSystem, world, f: int, blackout) -> None:
    """World frame f through the system's sensor entry point."""
    sensor = system.cfg.sensor
    if sensor == "rgbd":
        system.track_rgbd(*world.rgbd_pair(f), world.timestamps[f])
    elif sensor == "monocular":
        system.track_monocular(world.render(f), world.timestamps[f])
    else:
        system.track_stereo(*frame_pair(world, f, blackout), world.timestamps[f])


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
        return {"closed_at_kf": None, "loop_edges": [], "n_sim3_attempts": 0, "last_report": {}, "gba_log": []}
    return {
        "closed_at_kf": int(closer.last_loop_kf) if closer.n_loops_closed else None,
        "loop_edges": [(int(a), int(b)) for a, b, _ in closer.loop_edges],
        "n_sim3_attempts": closer.n_sim3_attempts,
        "last_report": closer.last_report,
        "gba_log": closer.gba_log,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=0, help="frames to track (default: 330, or all of figure8)")
    ap.add_argument("--world", default="bench", choices=("bench", "figure8"))
    ap.add_argument("--geometry", default="kitti", choices=("kitti", "multi-loop"),
                    help="SlamConfig() at KITTI geometry, or the reference's TestMultiLoop configuration")
    ap.add_argument("--sync", type=int, default=8)
    ap.add_argument("--device", default=None, help="cpu, cuda, cuda:1 ... (default: the first CUDA device)")
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--no-loop-closer", action="store_true", help="tracking and mapping alone")
    ap.add_argument("--blackout", default="", help="A-B: frames A..B (inclusive) become a blank gray pair")
    ap.add_argument("--sensor", default="stereo", choices=("stereo", "rgbd", "monocular"))
    ap.add_argument("--mesh", type=int, default=0, help="N: the post-loop global BA over LocalMesh(N) on the device")
    ap.add_argument("--depth", type=int, default=2, help="the tracker's pipeline depth (1: serial)")
    args = ap.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)

    cfg = SlamConfig() if args.geometry == "kitti" else multi_loop_config()
    if args.world == "figure8":
        world = figure_eight_world(cfg)
        args.frames = args.frames or world.num_frames
    else:
        args.frames = args.frames or 330
        world = bench_world(cfg, num_frames=max(args.frames, 330))
    mesh = None
    if args.mesh:
        mesh = LocalMesh(args.mesh, resolve_device(args.device))
    system = SlamSystem(cfg, sensor=args.sensor, sync_every=args.sync, device=args.device,
                        place_recognition=not args.no_loop_closer, mesh=mesh)
    system.tracker.pipeline_depth = args.depth
    blackout = parse_blackout(args.blackout)
    if blackout and args.sensor != "stereo":
        ap.error("--blackout takes the stereo sensor")
    t0 = time.perf_counter()
    loops_at = []
    for f in range(args.frames):
        feed(system, world, f, blackout)
        if system.loop_closer and system.loop_closer.n_loops_closed > len(loops_at):
            loops_at.append(f)
    stats = system.shutdown()
    wall = time.perf_counter() - t0
    est = system.frame_poses()
    records = system.tracker.records
    print(json.dumps({
        "device": str(system.device), "mesh": repr(mesh) if mesh else None, "world": args.world, "sensor": args.sensor, "frames": args.frames, "sync_every": args.sync,
        "pipeline_depth": args.depth,
        "wall_s_with_rendering": wall, "frames_per_s_with_rendering": args.frames / wall,
        "ate_m": (trajectory.ate_rmse(est, world.poses[: args.frames], align="se3")
                  if args.sensor != "monocular" and len(est) == args.frames else None),
        "lost": sum(1 for r in records if r.lost),
        "first_lost_frame": next((r.frame_id for r in records if r.lost), None),
        "stats": stats,
        **loop_summary(system),
        "loops_at_frames": loops_at,
        **(blackout_summary(system, world, blackout) if blackout else {}),
        **(sensor_summary(system, world, args.frames) if args.sensor != "stereo" else {}),
        "timers": system.tracker.timers.summary(),
    }, default=float), flush=True)


if __name__ == "__main__":
    main()
