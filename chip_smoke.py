#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`slam_framework_torch`) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. card: prints `nvidia-smi --query-gpu=name,power.limit`, requires CUDA;
  2. build: compiles the FAST+NMS kernel (csrc/fast_nms.cu, nvcc, sm_90a);
  3. kernel vs plain on the card: all 8 pyramid levels of both images of
     bench frame 0, plus a random 75x140 image; tolerance 0 (torch.equal);
     per-level times with CUDA events (median of 20 launches);
  4. main path: the bench world (bench.py's parameters) at 1241x376, the first
     49 stereo pairs (the initial frame + 6 chunks of 8) staged on the card,
     then a stereo SlamSystem (SlamConfig(), sync_every=8) through
     track_stereo_device; prints frames/s, ATE against ground truth
     (SE3-aligned), lost frames, keyframes, map points, kernel launches and
     peak device memory.
Then one JSON line describing the kernel, and the device line last.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

# Tracking only (no local mapper yet) holds the bench world for ~50 frames:
# from frame 52 on, the port and the reference tracker alike lose it.
N_FRAMES = 49
SYNC = 8
# Twice the port's ATE over the same 49 frames on the CPU (0.2809 m).
ATE_BOUND_M = 0.562
REPLACES = "slam_framework_tpu/ops/fast_pallas.py:114"


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _cuda_ms(fn, reps: int = 20) -> float:
    """Median device time of fn() over reps launches, CUDA events, after warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    dev = torch.device("cuda", 0)

    from slam_framework_torch.config import SlamConfig
    from slam_framework_torch.io import synthetic, trajectory
    from slam_framework_torch.ops import fast_cuda, pyramid
    from slam_framework_torch.system import SlamSystem

    # ---- 2. build
    t0 = time.perf_counter()
    so = fast_cuda.build()
    print(f"build: {so} in {time.perf_counter() - t0:.2f} s", flush=True)

    # ---- 3. kernel vs plain on the card
    cfg = SlamConfig()
    t0 = time.perf_counter()
    world = synthetic.make_world(
        num_frames=330, cam=cfg.camera, seed=3, speed=1.0,
        yaw_rate=2.0 * np.pi / 300.0, num_landmarks=22000,
    )
    pairs_np = [world.stereo_pair(f) for f in range(N_FRAMES)]
    print(f"world: {N_FRAMES} pairs rendered in {time.perf_counter() - t0:.1f} s", flush=True)

    left, right = (torch.from_numpy(a).to(dev).float() for a in pairs_np[0])
    levels = list(zip(
        pyramid.build_pyramid(left, cfg.orb.num_levels, cfg.orb.scale_factor),
        pyramid.build_pyramid(right, cfg.orb.num_levels, cfg.orb.scale_factor),
    ))
    rng = np.random.default_rng(7)
    odd = torch.from_numpy(rng.integers(0, 256, (1, 75, 140)).astype(np.float32)).to(dev)
    max_err = 0.0
    kernel_ms = plain_ms = 0.0
    cases = [(f"level {i} {tuple(l.shape)}", torch.stack([l, r])) for i, (l, r) in enumerate(levels)]
    cases.append(("random (75, 140)", odd))
    for name, imgs in cases:
        got = fast_cuda.fast_nms_strength(imgs)
        want = fast_cuda.fast_nms_strength_plain(imgs)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            _fail(f"kernel != plain at {name}: max abs err {err}")
        if name.startswith("level"):
            # timed as the main path calls it: one launch per image
            k = sum(_cuda_ms(lambda im=im: fast_cuda.fast_nms_strength(im)) for im in imgs)
            p = sum(_cuda_ms(lambda im=im: fast_cuda.fast_nms_strength_plain(im)) for im in imgs)
            kernel_ms += k
            plain_ms += p
            print(f"fast_nms {name}: equal, L+R kernel {k:.4f} ms, plain {p:.4f} ms", flush=True)
        else:
            print(f"fast_nms {name}: equal", flush=True)
    print(f"fast_nms per stereo frame (16 calls): kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms",
          flush=True)

    # ---- 4. main path
    pairs = [torch.from_numpy(np.stack([l, r])).to(dev) for l, r in pairs_np]
    torch.cuda.synchronize()
    warm = SlamSystem(cfg, sensor="stereo", sync_every=SYNC, device=dev)
    for f in range(SYNC + 1):
        warm.track_stereo_device(pairs[f], world.timestamps[f])
    warm.shutdown()
    del warm

    system = SlamSystem(cfg, sensor="stereo", sync_every=SYNC, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fast_cuda.launches = 0
    t0 = time.perf_counter()
    for f in range(N_FRAMES):
        system.track_stereo_device(pairs[f], world.timestamps[f])
    system.tracker.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fast_cuda.launches
    peak = torch.cuda.max_memory_allocated(dev)

    stats = system.shutdown()
    est = system.frame_poses()
    records = system.tracker.records
    lost = sum(1 for r in records if r.lost)
    if est.shape != (N_FRAMES, 4, 4) or not np.isfinite(est).all():
        _fail(f"trajectory shape {est.shape} or non-finite poses")
    ate = trajectory.ate_rmse(est, world.poses[:N_FRAMES], align="se3")
    print(
        f"main path: {N_FRAMES} frames in {wall:.3f} s = {N_FRAMES / wall:.3f} frames/s, "
        f"ATE {ate:.4f} m (bound {ATE_BOUND_M} m), lost {lost}, keyframes {stats['keyframes']}, "
        f"map points {stats['map_points']}, resets {stats['resets']}, fast_nms launches {launches}, "
        f"peak device memory {peak / 2**20:.1f} MiB",
        flush=True,
    )
    print(f"stage timers: {json.dumps(system.tracker.timers.summary())}", flush=True)
    state_tensors = list(system.tracker._dstate) + list(system.tracker._block)
    if any(t.device.type != "cuda" for t in state_tensors):
        _fail("a tracker state tensor is off the CUDA device")
    if lost or stats["resets"]:
        _fail(f"{lost} lost frames, {stats['resets']} resets")
    if launches < 16 * N_FRAMES:
        _fail(f"fast_nms launches {launches} < 16 x {N_FRAMES} frames")
    if not ate <= ATE_BOUND_M:
        _fail(f"ATE {ate} m above the bound {ATE_BOUND_M} m")

    print(json.dumps({"kernels": [{
        "name": "fast_nms_strength",
        "route": "cuda",
        "source": "slam_framework_torch/csrc/fast_nms.cu",
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
