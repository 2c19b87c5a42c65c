#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`slam_framework_torch`) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. card: prints `nvidia-smi --query-gpu=name,power.limit`, requires CUDA;
  2. build: compiles the FAST+NMS kernel (csrc/fast_nms.cu, nvcc, sm_90a) and
     says whether the arena's native host library built (g++);
  3. kernel vs plain on the card: all 8 pyramid levels of both images of
     bench frame 0 in ONE launch, then images of odd shapes (75x140; 7x5;
     200x17, narrower than a tile and taller; signed values) in one launch, and
     the single-shape batch form; tolerance 0 (torch.equal). Then the
     kernel's time per stereo frame: device time from a CUDA graph of 50
     16-image calls between two events (L2 warm, as the front-end finds the
     levels it has just written; and with the L2 flushed before every call),
     the host's time for the one wrapper call, the plain version's device
     time, and the bound from this frame's pixel count;
  4. main path: the bench world (bench.py's parameters) at 1241x376, the first
     49 stereo pairs (the initial frame + 6 chunks of 8) staged on the card,
     then a stereo SlamSystem (SlamConfig(), sync_every=8) through
     track_stereo_device; prints frames/s, ATE against ground truth
     (SE3-aligned), lost frames, keyframes, map points, kernel launches (one
     per frame) and peak device memory.
Then one JSON line describing the kernel, and the device line last.
"""

from __future__ import annotations

import json
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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False")
    from slam_framework_torch import native
    from slam_framework_torch.config import SlamConfig
    from slam_framework_torch.io import synthetic, trajectory
    from slam_framework_torch.ops import fast_cuda, pyramid
    from slam_framework_torch.system import SlamSystem
    from slam_framework_torch.utils import cuda_timing as timing

    print(timing.card_line(), flush=True)  # the card's name and power limit, as nvidia-smi gives them
    dev = torch.device("cuda", 0)

    # ---- 2. build
    t0 = time.perf_counter()
    so = fast_cuda.build()
    print(f"build: {so} in {time.perf_counter() - t0:.2f} s", flush=True)
    # without it the arena silently takes its numpy loops on the host
    print(f"native arena library built: {native.load_arena_ops() is not None}", flush=True)

    # ---- 3. kernel vs plain on the card
    cfg = SlamConfig()
    t0 = time.perf_counter()
    world = synthetic.make_world(
        num_frames=330, cam=cfg.camera, seed=3, speed=1.0,
        yaw_rate=2.0 * np.pi / 300.0, num_landmarks=22000,
    )
    pairs_np = [world.stereo_pair(f) for f in range(N_FRAMES)]
    print(f"world: {N_FRAMES} pairs rendered in {time.perf_counter() - t0:.1f} s", flush=True)

    levels = []
    for img in pairs_np[0]:
        levels += pyramid.build_pyramid(torch.from_numpy(img).to(dev).float(),
                                        cfg.orb.num_levels, cfg.orb.scale_factor)
    rng = np.random.default_rng(7)
    odd = [torch.from_numpy(rng.integers(0, 256, s).astype(np.float32)).to(dev)
           for s in ((75, 140), (7, 5), (200, 17), (61, 99))]
    odd[-1] = odd[-1] * 0.37 - 47.3  # values of both signs that are not whole numbers
    max_err = 0.0
    for what, imgs in (("frame 0, 8 levels x 2 images", levels), ("odd shapes", odd)):
        fast_cuda.launches = 0
        got = fast_cuda.fast_nms_strength_levels(imgs)
        torch.cuda.synchronize()
        if fast_cuda.launches != 1:
            _fail(f"{what}: {fast_cuda.launches} launches for one call")
        for g, img in zip(got, imgs):
            want = fast_cuda.fast_nms_strength_plain(img)
            max_err = max(max_err, float((g - want).abs().max()))
            if not torch.equal(g, want):
                _fail(f"kernel != plain at {what} {tuple(img.shape)}: max abs err {max_err}")
        print(f"fast_nms {what}: {[tuple(t.shape) for t in imgs]} equal in one launch", flush=True)
    batch = torch.stack([odd[0], odd[0].flip(0)])
    if not torch.equal(fast_cuda.fast_nms_strength(batch), fast_cuda.fast_nms_strength_plain(batch)):
        _fail("kernel != plain on a (2, 75, 140) batch")

    def frame_call():
        return fast_cuda.fast_nms_strength_levels(levels)

    pixels = sum(t.numel() for t in levels)
    bound, bound_by = timing.bound_ms(pixels * fast_cuda.BYTES_PER_PIXEL, pixels * fast_cuda.OPS_PER_PIXEL)
    kernel_ms = timing.device_ms(frame_call)
    flushed_ms = timing.device_ms_flushed(frame_call, timing.l2_flusher(dev))
    host_ms = timing.host_ms(frame_call)
    event_ms = timing.event_ms(frame_call)
    plain_ms = timing.device_ms(lambda: [fast_cuda.fast_nms_strength_plain(t) for t in levels], calls=5)
    level_us = [timing.device_ms(lambda t=t: fast_cuda.fast_nms_strength_levels([t])) * 1e3
                for t in levels[: cfg.orb.num_levels]]
    print(
        f"fast_nms per stereo frame ({len(levels)} images, {pixels} px, one launch): device "
        f"{kernel_ms:.5f} ms L2-warm, {flushed_ms:.5f} ms L2-flushed; bound {bound:.5f} ms by {bound_by} "
        f"({100 * bound / kernel_ms:.1f}% of it reached); host {host_ms:.5f} ms per call "
        f"({event_ms:.5f} ms between events around one eager call); plain {plain_ms:.4f} ms device",
        flush=True,
    )
    print("fast_nms one level image per launch, device us: "
          + ", ".join(f"{tuple(t.shape)} {us:.2f}" for t, us in zip(levels, level_us)), flush=True)

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
    if launches != N_FRAMES:
        _fail(f"fast_nms launches {launches} != one per frame over {N_FRAMES} frames")
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
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this function
        "ms_l2_flushed": flushed_ms,
        "host_ms": host_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
