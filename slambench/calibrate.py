"""Readings for the limits of `correct`: many seeds of a cell in one process.

    python -m slambench.calibrate --workload kitti-stereo.drive --seeds 11,12,13 --seconds 51 \
        [--tf32 | --fault frozen_pose]

Runs the cell as `slambench/run.py` does, once per seed (the program's
set-up again for each, the process and its built kernels shared), and prints
one JSON line per seed with every number the check computes, the end-to-end
metrics and `correct` under the cell's current limits. `--tf32` is the
control: the program's float32 matrix products in TF32, the nearest precision
below the one the configuration states (float32 with TF32 off); it has to
come out not correct. `--fault` plants one of `slambench/faults.py`'s faults
as the window opens. The lower reading of a number is the largest over the
program's seeds, the upper the smallest over the control's and the faults'
(`slambench/limits/<workload>.json` keeps both beside the limit). Each line
also says how many keyframes the map held as the window opened and the
pipeline's depth then, which is how the mix's pre-roll was chosen: the
smallest multiple of 8 frames after which the map holds the tracker's
`MATURE_MAP_KFS` (depth 2 on) on every seed.
"""

from __future__ import annotations

import os

from slambench import manifest

manifest.pin_host_threads()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma list")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tf32", action="store_true")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("calibration needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(manifest.HOST_THREADS)
    from slambench import faults, harness

    fault = faults.FAULTS[args.fault] if args.fault else None
    cell = manifest.Cell(manifest.benchmark(), args.workload)
    config_file = os.path.join(manifest.ROOT, cell.config_entry["file"])
    for seed in (int(s) for s in args.seeds.split(",")):
        tag = {"workload": args.workload, "seed": seed, "tf32": args.tf32, "fault": args.fault}
        try:
            res = harness.run_cell(config_file, cell.mix, cell.limits, seed, args.seconds, False,
                                   time.perf_counter(), tf32=args.tf32, fault=fault)
        except Exception as exc:  # a control that crashes has failed: record it and go on
            print(json.dumps({**tag, "correct": False, "error": repr(exc)}), flush=True)
            continue
        win = res["window"]
        line = {**tag, "correct": res["correct"],
                "numbers": {k: (v if math.isfinite(v) else None) for k, v in res["numbers"].items()},
                "frames_per_s": win["frames_per_s"], "pose_latency_p95_ms": win["latency_p_ms"],
                "setup_s": res["setup_s"], "setup_parts": res["setup_parts"], "failed": win["failed"],
                "attempted": win["attempted"],
                "keyframes_in_window": res["keyframes_in_window"], "kfs_at_open": res["kfs_at_open"],
                "depth_at_open": res["depth_at_open"], "stats": res["stats"], "check_s": res["check_s"],
                "host": res["host"]}
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
