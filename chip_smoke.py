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
  4. mapper programs on the card against the CPU (a device check, not a kernel
     check: these programs are plain PyTorch, as they are left to XLA in the
     reference): a seeded synthetic BA problem at the default capacities (32
     cameras, 4096 points, 16384 observation slots, 8 per point) through
     `local_ba.optimize` on cuda and on cpu: camera centres within 2 mm, inlier
     masks equal on all but 16 of the 16,000 observations, two runs on the
     card bit-equal; then `triangulate_with_neighbors` + `compact_first_match`
     and `fuse_points_into_kfs` at 10 neighbours x 2048 features on blocks made
     from the FrameData of bench frames 0-10: the same pairs / associations on
     all but 0.5%, points within 1 cm, two runs bit-equal. Prints ms and
     launches per call;
  5. main path: the bench world (bench.py's parameters) at 1241x376, the first
     329 stereo pairs (the initial frame + 41 chunks of 8: the whole script
     stays within half of its 1200 s limit, so the shorter 161 was not
     needed) staged on the card, then a stereo SlamSystem (SlamConfig(),
     sync_every=8: tracker + local mapper) through track_stereo_device; prints
     frames/s, ATE against ground truth (SE3-aligned), lost frames,
     keyframes, map points, culled keyframes, BAs applied / aborted,
     triangulated points, fused observations and merges, cap_clips, kernel
     launches (one per frame), peak device memory and the stage timers.
     Fails on a lost frame, a reset, a launch count other than one per frame,
     a state tensor off the card, ATE above its bound, 12 keyframes or fewer,
     no BA applied or no triangulated point.
Then one JSON line describing the kernel, and the device line last.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

# With the local mapper the port holds the bench world over its loop-free
# length: the initial frame + 41 chunks of 8 (frame 330 would close the loop).
N_FRAMES = 329
SYNC = 8
# Twice the port's ATE over the same 329 frames on the CPU (ATE_CPU_M, from
# `python -m slam_framework_torch.tools.track_bench_world --frames 329 --device cpu`).
ATE_CPU_M = 0.5559
ATE_BOUND_M = 2 * ATE_CPU_M
# mapper programs, card against CPU
BA_CENTRE_TOL_M = 2e-3
BA_INLIER_MISMATCH_MAX = 16      # of 16,000 observations
MATCH_MISMATCH_FRAC_MAX = 0.005  # of the features / (neighbour, feature) entries
TRI_POINT_TOL_M = 0.01
REPLACES = "slam_framework_tpu/ops/fast_pallas.py:114"


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _count_launches(torch, fn):
    """(kernels, memcpys + memsets) the device ran for one fn(), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
    copies = sum(1 for e in dev_events if e.name.startswith(("Memcpy", "Memset")))
    if not dev_events:
        _fail("torch.profiler recorded no device event")
    return len(dev_events) - copies, copies


def _equal_runs(torch, a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _mapper_programs(torch, dev, cfg, world, pairs_np, timing) -> None:
    """Phase 4: the mapper's device programs on the card against the CPU."""
    from slam_framework_torch.geometry import se3
    from slam_framework_torch.optim import local_ba
    from slam_framework_torch.pipeline import mapping_ops
    from slam_framework_torch.pipeline.frame import StereoFrontend
    from slam_framework_torch.tools import ba_synthetic

    cpu = torch.device("cpu")
    cap = cfg.capacity
    torch.cuda.reset_peak_memory_stats(dev)

    # ---- local BA at the default capacities
    syn = ba_synthetic.build_problem(seed=11, C=cap.ba_cams, P=cap.ba_points, M=cap.ba_obs,
                                     O=cap.ba_obs_per_point)
    Kba = ba_synthetic.K_SYNTHETIC

    def problem(device):
        return local_ba.BAProblem(**{k: torch.from_numpy(v).to(device) for k, v in syn.arrays.items()})

    prob = problem(dev)

    def run_ba():
        return local_ba.optimize(prob, Kba, iters_first=cfg.mapping.local_ba_iters_first,
                                 iters_second=cfg.mapping.local_ba_iters_second)

    t0 = time.perf_counter()
    got = run_ba()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    again = run_ba()
    if not _equal_runs(torch, got, again):
        _fail("local_ba.optimize: two runs on the card differ")
    t0 = time.perf_counter()
    want = local_ba.optimize(problem(cpu), Kba)
    cpu_s = time.perf_counter() - t0

    def centres(poses):
        return se3.se3_inverse(poses.cpu())[:, :3, 3].numpy()

    n_cams = syn.poses_true.shape[0]
    centre_err = float(np.abs(centres(got.cam_pose) - centres(want.cam_pose)).max())
    truth_err = float(np.linalg.norm(centres(got.cam_pose)[:n_cams]
                                     - centres(torch.from_numpy(syn.poses_true)), axis=1).max())
    m_obs = int(syn.arrays["obs_mask"].sum())
    mismatch = int((got.obs_inlier.cpu() != want.obs_inlier).sum())
    print(f"local_ba card vs cpu ({cap.ba_cams} cams, {cap.ba_points} points, {cap.ba_obs} slots, {m_obs} "
          f"observations): camera centres differ by {centre_err:.3e} m (tolerance {BA_CENTRE_TOL_M}), inlier "
          f"masks differ on {mismatch} observations (at most {BA_INLIER_MISMATCH_MAX}), total chi2 "
          f"{float(got.total_chi2):.3f} vs {float(want.total_chi2):.3f}, worst camera {truth_err:.4f} m from "
          f"the truth, two card runs bit-equal; first call {first_s:.2f} s, cpu {cpu_s:.2f} s", flush=True)
    if not centre_err <= BA_CENTRE_TOL_M or mismatch > BA_INLIER_MISMATCH_MAX:
        _fail("local_ba.optimize disagrees between the card and the CPU")
    if not truth_err < 0.03:
        _fail(f"local_ba.optimize left a camera {truth_err} m from the truth")
    ba_event_ms = timing.event_ms(run_ba, reps=5)
    ba_host_ms = timing.host_ms(run_ba, reps=5)
    ba_kernels, ba_copies = _count_launches(torch, run_ba)
    try:  # an extra reading, not a check: device time alone, from a CUDA graph of one BA
        ba_graph_ms = f"{timing.device_ms(run_ba, calls=1, replays=3):.3f} ms"
    except Exception as e:  # noqa: BLE001
        ba_graph_ms = f"not measured ({type(e).__name__}: {str(e)[:120]})"
        torch.cuda.synchronize()
    print(f"local_ba per BA of 15 LM iterations: {ba_event_ms:.2f} ms between events around one eager call, "
          f"{ba_host_ms:.2f} ms of host time to enqueue it, {ba_kernels} kernels + {ba_copies} copies/memsets; "
          f"device time alone (CUDA graph): {ba_graph_ms}", flush=True)

    # ---- triangulation and fusion: blocks from the FrameData of bench frames 0..10
    frontend = StereoFrontend(cfg)
    K = frontend.K
    Nn = cfg.mapping.triangulation_neighbors
    fds = [frontend(*(torch.from_numpy(img).to(dev) for img in pairs_np[f])) for f in range(Nn + 1)]
    poses = torch.from_numpy(np.asarray(world.poses[: Nn + 1], np.float32)).to(dev)

    def block(f):
        fd = fds[f]
        return mapping_ops.KFBlock(pose=poses[f], xy=fd.xy, ur=fd.u_right, octave=fd.octave,
                                   angle=fd.angle, desc=fd.desc, cand=fd.valid)

    cur = block(Nn)
    nbrs = mapping_ops.KFBlock(*[torch.stack(f) for f in zip(*[block(f) for f in range(Nn)])])
    kw = dict(K=K, num_levels=cfg.orb.num_levels, scale_factor=cfg.orb.scale_factor)
    wh = (cfg.camera.width, cfg.camera.height)

    def on(device, blk):
        return mapping_ops.KFBlock(*[t.to(device) for t in blk])

    def run_tri(c=cur, n=nbrs):
        return mapping_ops.compact_first_match(
            mapping_ops.triangulate_with_neighbors(c, n, float(cfg.camera.baseline), **kw))

    # points of the current frame from its stereo depth, as the tracker makes them
    fd = fds[Nn]
    has = fd.valid & (fd.depth > 0)
    z = torch.where(has, fd.depth, torch.ones_like(fd.depth))
    Xc = torch.stack([(fd.xy[:, 0] - K.cx) * z / K.fx, (fd.xy[:, 1] - K.cy) * z / K.fy, z], dim=-1)
    Twc = se3.se3_inverse(poses[Nn])
    pt_pos = se3.transform_points(Twc, Xc)
    delta = pt_pos - Twc[:3, 3]
    dist = torch.linalg.vector_norm(delta, dim=-1)
    max_d = dist * cfg.orb.scale_factor ** fd.octave.float()
    pts_in = (pt_pos, fd.desc, delta / dist[:, None], max_d / cfg.orb.scale_factor ** (cfg.orb.num_levels - 1),
              max_d, has)

    def run_fuse(p=pts_in, n=nbrs):
        return mapping_ops.fuse_points_into_kfs(*p, n, image_wh=wh, **kw)

    tri, fuse = run_tri(), run_fuse()
    if not _equal_runs(torch, tri, run_tri()) or not torch.equal(fuse, run_fuse()):
        _fail("triangulation or fusion: two runs on the card differ")
    tri_cpu = run_tri(on(cpu, cur), on(cpu, nbrs))
    fuse_cpu = run_fuse(tuple(t.cpu() for t in pts_in), on(cpu, nbrs))
    tri_h = [t.cpu() for t in tri]
    same = (tri_h[3] == tri_cpu.valid) & (~tri_cpu.valid | ((tri_h[0] == tri_cpu.ni) & (tri_h[1] == tri_cpu.nf)))
    both = same & tri_cpu.valid
    tri_bad = int((~same).sum())
    pt_err = float((tri_h[2] - tri_cpu.pts)[both].abs().max()) if bool(both.any()) else 0.0
    fuse_bad = int((fuse.cpu() != fuse_cpu).sum())
    n_feat = tri_cpu.valid.numel()
    print(f"triangulation card vs cpu ({Nn} neighbours x {n_feat} features): {int(tri_cpu.valid.sum())} features "
          f"triangulated, {tri_bad} features with another (neighbour, feature) pair, points differ by "
          f"{pt_err:.3e} m (tolerance {TRI_POINT_TOL_M}); fusion: {int((fuse_cpu >= 0).sum())} associations, "
          f"{fuse_bad} of {fuse_cpu.numel()} entries differ; two card runs bit-equal", flush=True)
    if int(tri_cpu.valid.sum()) == 0 or int((fuse_cpu >= 0).sum()) == 0:
        _fail("triangulation or fusion found nothing on the bench frames")
    if (tri_bad > MATCH_MISMATCH_FRAC_MAX * n_feat or fuse_bad > MATCH_MISMATCH_FRAC_MAX * fuse_cpu.numel()
            or not pt_err <= TRI_POINT_TOL_M):
        _fail("triangulation or fusion disagrees between the card and the CPU")
    tri_k, tri_c = _count_launches(torch, run_tri)
    fuse_k, fuse_c = _count_launches(torch, run_fuse)
    print(f"triangulate_with_neighbors + compact_first_match: {timing.event_ms(run_tri, reps=5):.3f} ms per call "
          f"(events around one eager call), {tri_k} kernels + {tri_c} copies; fuse_points_into_kfs: "
          f"{timing.event_ms(run_fuse, reps=5):.3f} ms, {fuse_k} kernels + {fuse_c} copies; peak device memory "
          f"of this phase {torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB", flush=True)


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

    # ---- 4. mapper programs on the card against the CPU
    _mapper_programs(torch, dev, cfg, world, pairs_np, timing)

    # ---- 5. main path
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
    mapper = stats["mapper"]
    print(
        f"main path: {N_FRAMES} frames in {wall:.3f} s = {N_FRAMES / wall:.3f} frames/s, "
        f"ATE {ate:.4f} m (bound {ATE_BOUND_M} m), lost {lost}, keyframes {stats['keyframes']} "
        f"(+ {mapper['culled_keyframes']} culled), map points {stats['map_points']}, resets {stats['resets']}, "
        f"BAs applied {mapper['ba_applied']} / aborted {stats['ba_aborts']}, triangulated points "
        f"{mapper['triangulated']}, fused observations {mapper['fused_obs']}, merges {mapper['merged']}, "
        f"cap_clips {json.dumps(stats['cap_clips'])}, fast_nms launches {launches}, "
        f"peak device memory {peak / 2**20:.1f} MiB",
        flush=True,
    )
    print(f"stage timers: {json.dumps(system.tracker.timers.summary())}", flush=True)
    store = system.tracker.local_mapper.kf_store
    state_tensors = list(system.tracker._dstate) + list(system.tracker._block) + [store.packs, store.descs]
    if any(t.device.type != "cuda" for t in state_tensors):
        _fail("a tracker or mapper state tensor is off the CUDA device")
    if stats["keyframes"] <= 12 or mapper["ba_applied"] < 1 or mapper["triangulated"] < 1:
        _fail(f"the mapper did not work: {stats['keyframes']} keyframes, {mapper['ba_applied']} BAs applied, "
              f"{mapper['triangulated']} triangulated points")
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
