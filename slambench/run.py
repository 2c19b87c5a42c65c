"""Run one cell of the benchmark and print its result as the last line.

    python -m slambench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Needs as many CUDA devices as the cell asks for: without them it exits 2 and
prints no result. `--trace 0` reports the cell's end-to-end metrics, `--trace
1` its per-layer metrics, the device's busy and traced seconds, and a
breakdown of the traced stretch. Every run checks what the timed path
produced against the plain reference and prints each compared number beside
its limit, as the last lines on standard error and under `checks`, the last
key of the result. A run that ends with JAX, its libraries or the JAX package
loaded, or with a reference that reaches into the program, exits 3 and prints
no result. The host's math libraries run one thread (`manifest.HOST_THREADS`).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from slambench import manifest  # noqa: E402

manifest.pin_host_threads()


def _fixed_caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own FAST and arena libraries live in its `build/` directory)."""
    base = os.path.join(manifest.PACKAGE, ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def _end_to_end(res: dict) -> dict:
    return {"frames_per_s": res["window"]["frames_per_s"], "setup_s": res["setup_s"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _fixed_caches()

    import torch

    torch.set_num_threads(manifest.HOST_THREADS)
    cell = manifest.Cell(manifest.benchmark(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2

    from slambench import check, harness

    res = harness.run_cell(
        os.path.join(manifest.ROOT, cell.config_entry["file"]), cell.mix, cell.limits, args.seed, args.seconds,
        bool(args.trace), T_START, readers=cell.readers() if args.trace else None)

    bad = check.forbidden_modules()
    if bad:
        print(f"the run ends with forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    impure = check.reference_imports_program()
    if impure:
        print(f"the reference is not plain: {impure}", file=sys.stderr)
        return 3

    win = res["window"]
    if args.trace:
        metrics = {m["name"]: {"value": res["per_layer"][m["name"]], "unit": m["unit"]}
                   for m in cell.per_layer if m["name"] in res["per_layer"]}
    else:
        values = _end_to_end(res)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    finite = all(math.isfinite(v["value"]) for v in metrics.values())
    if not finite:
        print("a metric has no value (no frame of the window came back): the run is not correct", file=sys.stderr)
        metrics = {k: {**v, "value": v["value"] if math.isfinite(v["value"]) else None} for k, v in metrics.items()}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    if res["trace"] is not None:
        device.update(busy_s=res["trace"]["busy_s"], window_s=res["trace"]["window_s"])
    detail = {k: res[k] for k in ("preroll", "window_frames", "n_frames", "kfs_at_open", "depth_at_open",
                                  "keyframes_in_window", "ran_out", "check_s", "stats", "setup_parts")}
    detail.update({k: win[k] for k in ("window_s", "frames_posed", "latency_samples", "latency_median_ms",
                                       "latency_p_ms")})
    detail["host"] = res["host"]
    if res["trace"] is not None:
        detail["trace"] = res["trace"]
    detail["numbers"] = {k: (v if math.isfinite(v) else None) for k, v in res["numbers"].items()}
    print(json.dumps({"run": detail}), file=sys.stderr)
    result = {"correct": res["correct"] and finite, "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics, "device": device}
    if res["breakdown"] is not None:
        result["breakdown"] = res["breakdown"]
    result["checks"] = {k: {"value": (c["value"] if math.isfinite(c["value"]) else None), "limit": c["limit"]}
                        for k, c in res["checks"].items()}
    for k, c in res["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r} {'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
