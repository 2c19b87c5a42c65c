#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`slam_framework_torch`) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. card: prints `nvidia-smi --query-gpu=name,power.limit`, requires CUDA;
  2. build: compiles the FAST+NMS kernel (csrc/fast_nms.cu, nvcc, sm_90a) and
     says whether the arena's native host library built (g++);
  3. kernel vs plain on the card: all 8 pyramid levels of both images of
     bench frame 0 in ONE launch, the 8 levels of one image as an RGB-D and a
     monocular frame hand them over (bench frames 0 and 1) in one launch each,
     then images of odd shapes (75x140; 7x5;
     200x17, narrower than a tile and taller; signed values) in one launch, and
     the single-shape batch form; tolerance 0 (torch.equal). Then the
     kernel's time per stereo frame: device time from a CUDA graph of 50
     16-image calls between two events (L2 warm, as the front-end finds the
     levels it has just written; and with the L2 flushed before every call),
     the host's time for the one wrapper call, the plain version's device
     time, and the bound from this frame's pixel count; the same for the
     8-image list of one RGB-D / monocular frame;
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
  5. loop programs on the card against the CPU (plain PyTorch, as they are
     XLA programs in the reference), each run twice for bit-equality, with
     kernels and ms per call: the vocabulary `transform` on the 2048
     descriptors of three bench frames (word ids, groups and weights exactly
     equal); `solve_sim3_ransac` on a synthetic two-view set in 2048 slots with
     the same index sets (R, t within 1e-4, inlier flags equal up to 2 flips);
     `pose_graph.optimize` on a drifted ring of 128 vertices (camera centres
     within 1e-4 m, cost before and after printed); `optimize_global` on a
     synthetic map of the bench world's size at its closure (80 cameras,
     17,665 points, 105,990 observations in 128 / 32,768 / 131,072 slots;
     camera centres within 2 mm, total chi2 within 0.1%), plus its device
     time replayed as one CUDA graph if it captures;
  5b. relocalization programs on the card against the CPU (plain PyTorch, as
     they are XLA programs in the reference): a synthetic matched set in the
     2048 frame slots the relocalizer hands its solvers (300 matches, 30% gross
     outliers, stereo depth on 90% of them, 256 hypotheses, the same index sets
     on both sides) through `solve_pnp3d_ransac` and `solve_pnp_ransac`: R within
     1e-4 (the 2-D solver's DLT: 5e-4), t within 1e-3 m, inlier flags equal on
     all but 2, two card runs bit-equal, ms and kernels per call;
  6. main path: the bench world (bench.py's parameters) at 1241x376, all 330
     stereo pairs (the circle meets itself) staged on the card, then a stereo
     SlamSystem (SlamConfig(), sync_every=8, the shipped vocabulary: tracker,
     local mapper, place recognition, loop closer, global BA) through
     track_stereo_device; prints frames/s, ATE against ground truth
     (SE3-aligned) at the end and, over the frames tracked before the
     closure, just before it and at the end; the keyframe at which the loop
     closed and its loop keyframe, the loop closer's last report, its Sim3
     attempts and the time inside the loop stage; lost frames, keyframes, map
     points, culled keyframes, BAs applied / aborted, triangulated points,
     fused observations and merges, cap_clips, kernel launches (one per
     frame), peak device memory and the stage timers. Fails on a lost frame,
     a reset, no closed loop, a global BA not merged, a launch count other
     than one per frame, a state tensor off the card, ATE above its bound, 12
     keyframes or fewer, no BA applied or no triangulated point. The system's
     map is then saved (`save_map`) under slam_framework_torch/build/;
  7. blackout run: the same 330 pairs with frames 110-112 replaced by a uniform
     gray (90) pair on the card, through a fresh SlamSystem. Fails unless
     tracking is lost at the blackout, a frame after 112 relocalizes (its frame,
     keyframe, inliers and the attempts are printed), 0 resets, a loop closes
     with its global BA merged, lost frames are at most the reference's count
     on the same pixels plus sync_every, the ATE over the tracked frames is at
     most twice the port's CPU figure, 330 FAST launches and every state tensor
     on the card. Prints the time per relocalization attempt, the kernels and
     copies of one attempt, and the stage timers. Then the first attempt after
     the blackout is replayed: the map as it stood just before it (saved with
     `checkpoint.save_map`), the relocalizer's generator state and the frame's
     feature block are loaded into fresh systems on the card and on the CPU,
     and each replays the attempt from those features, then from the frame's
     pixels through its own front-end; the per-candidate reports (BoW matches,
     RANSAC, motion-only BA and guided-retry inliers) are printed side by side
     with the live attempt's;
  8. resume run: a fresh SlamSystem loads the saved map (`load_map`), goes into
     localization mode and is fed bench frames 200-229. Fails unless it is LOST
     after the load, one of the first three frames relocalizes, at least 25 of
     the 30 are tracked, the keyframe count is unchanged, every tracked camera
     centre is within 0.3 m of the truth once the map's world is aligned to the
     truth's over these frames (SE3, through the saved trajectory's centres of
     the same frames), and the frames made 30 FAST launches. Prints the file's
     size, the save and load times, and each frame's distance to the saved
     trajectory (between keyframes the saved records carry the first run's own
     tracking error, up to ~0.3 m; at its keyframes they agree within 1 cm);
  9. RGB-D run: the same 330 frames as (left image, its ray-cast depth)
     through an RGB-D SlamSystem's `track_rgbd` (the depth comes from the ray
     cast that rendered the left image: no second ray cast). Fails unless lost
     frames are at most the reference's on the same pixels plus sync_every,
     loops closed at least the reference's, the SE3-aligned ATE at most twice
     the reference's CPU ATE, one FAST launch (8 images) per frame and every
     state tensor on the card;
  10. monocular run: the left images through a monocular SlamSystem's
     `track_monocular` (tools/bench_mono.py's world). Prints the init frame and
     the map's median depth after it. Held like phase 9, with frames without a
     tracked pose in place of lost frames and the Sim3-aligned ATE.
The world is rendered by a pool of worker processes. Then the smoke's total
time, one JSON line describing the kernel, and the device line last.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import sys
import time

import numpy as np

# The whole bench sequence: the circle meets itself and the loop closer must fire.
N_FRAMES = 330
SYNC = 8
# Twice the port's ATE over the same 330 frames on the CPU (ATE_CPU_M, from
# `python -m slam_framework_torch.tools.track_bench_world --frames 330 --device cpu`).
ATE_CPU_M = 0.3377
ATE_BOUND_M = 2 * ATE_CPU_M
# mapper programs, card against CPU
BA_CENTRE_TOL_M = 2e-3
BA_INLIER_MISMATCH_MAX = 16      # of 16,000 observations
MATCH_MISMATCH_FRAC_MAX = 0.005  # of the features / (neighbour, feature) entries
TRI_POINT_TOL_M = 0.01
# loop programs, card against CPU
SIM3_TOL = 1e-4
SIM3_INLIER_FLIPS_MAX = 2
POSE_GRAPH_CENTRE_TOL_M = 1e-4
GBA_CENTRE_TOL_M = 2e-3
GBA_CHI2_REL_TOL = 1e-3
BOW_FRAMES = (0, 150, 300)
# relocalization programs, card against CPU. The 2-D solver's pose comes from a
# weighted 12x12 DLT whose smallest fp32 eigenvector cuSOLVER and LAPACK put
# 1.17e-4 apart in R with identical inlier sets (the pose itself is 3.4e-4 from
# the truth; first run on an H100): its R is held to 5e-4, the 3-D solver's to 1e-4.
PNP_R_TOL = {"solve_pnp3d_ransac": 1e-4, "solve_pnp_ransac": 5e-4}
PNP_T_TOL_M = 1e-3
PNP_INLIER_FLIPS_MAX = 2
# blackout run: frames 110-112 blank. The reference SlamSystem on the same pixels
# on the CPU loses frames 110-120 (11) and relocalizes at frame 121 against
# keyframe 26 (`JAX_PLATFORMS=cpu python tools/ref_reloc_bench_world.py`).
BLACKOUT = range(110, 113)
REF_LOST = 11
# Twice the port's ATE over the tracked frames of the same run on the CPU
# (`python -m slam_framework_torch.tools.track_bench_world --frames 330
# --blackout 110-112 --device cpu`: lost 110-112, relocalized at frame 113
# against keyframe 26, loop at keyframe 70 against 1, ATE 0.3725 m).
ATE_BLACKOUT_CPU_M = 0.3725
ATE_BLACKOUT_BOUND_M = 2 * ATE_BLACKOUT_CPU_M
# resume run. The bar is the reference test's (tests/test_system.py:139, against
# the truth). The map's world is aligned to the truth's over the resumed frames
# through the saved trajectory of the same frames: the map sits ~0.4 m off the
# truth there, and the saved records between keyframes are no reference for a
# single frame (0.28-0.30 m from the resumed poses at frames 227-229 on the CPU
# and on an H100, 0.005 m at the saved keyframes' frames; the resumed poses are
# within 0.16 m of the truth after the alignment, the saved ones 0.26 m).
RESUME_FRAMES = range(200, 230)
RESUME_MIN_TRACKED = 25
RESUME_CENTRE_TOL_M = 0.3
# RGB-D and monocular runs. The reference SlamSystem on the same pixels on the
# CPU (`JAX_PLATFORMS=cpu python tools/ref_sensor_bench_world.py --sensor rgbd`
# / `--sensor monocular`): RGB-D 0 lost, 1 loop (keyframe 74 against 0), 80
# keyframes, ATE 0.4484 m (SE3); monocular initialized at frame 1 (against 0),
# every frame tracked, 1 loop (keyframe 51 against 1), 49 keyframes, ATE
# 0.4452 m (Sim3). Bounds: lost (untracked) <= the reference's + SYNC, loops
# >= the reference's, ATE <= twice the reference's.
REF_RGBD = {"lost": 0, "loops": 1, "ate_m": 0.4484}
REF_MONO = {"untracked": 0, "loops": 1, "ate_m": 0.4452}
MONO_FRAMES = 330
RENDER_PROCS = 8
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


def _timed(torch, timing, name, fn, reps=5, graph=False) -> str:
    """'<ms> ms per call, <n> kernels + <c> copies' of one eager fn() on the card."""
    ms = timing.event_ms(fn, reps=reps)
    kernels, copies = _count_launches(torch, fn)
    out = f"{name}: {ms:.3f} ms per call (events around one eager call), {kernels} kernels + {copies} copies"
    if graph:
        try:  # an extra reading, not a check: device time alone, from a CUDA graph of one call
            out += f"; device time alone (CUDA graph): {timing.device_ms(fn, calls=1, replays=3):.3f} ms"
        except Exception as e:  # noqa: BLE001
            out += f"; device time alone (CUDA graph): not measured ({type(e).__name__}: {str(e)[:120]})"
            torch.cuda.synchronize()
    return out


def _ring_problem(n: int = 128, pad_e: int = 256, seed: int = 5):
    """A drifted ring as a pose graph, numpy fields: n cameras on a circle, the
    estimates carrying accumulated odometry noise, exact relative poses on the
    ring edges (k -> k+1, the last closing the loop) and on (k -> k+2) chords,
    vertex 0 fixed, edge slots padded to `pad_e`."""
    rng = np.random.default_rng(seed)
    gt = np.zeros((n, 4, 4))
    for k in range(n):
        a = 2 * np.pi * k / n
        fwd, up = np.array([-np.sin(a), np.cos(a), 0.0]), np.array([0.0, 0.0, -1.0])
        Twc = np.eye(4)
        Twc[:3, :3] = np.stack([np.cross(up, fwd), up, fwd], axis=1)
        Twc[:3, 3] = [30.0 * np.cos(a), 30.0 * np.sin(a), 0.0]
        gt[k] = np.linalg.inv(Twc)
    est = [gt[0]]
    for k in range(1, n):
        w, u = rng.normal(0, 0.004, 3), rng.normal(0, 0.02, 3)
        th = np.linalg.norm(w)
        Wx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        noise = np.eye(4)
        noise[:3, :3] = np.eye(3) + np.sin(th) / th * Wx + (1 - np.cos(th)) / th**2 * (Wx @ Wx)
        noise[:3, 3] = u
        est.append(noise @ gt[k] @ np.linalg.inv(gt[k - 1]) @ est[-1])
    est = np.stack(est)
    e_i = np.concatenate([np.arange(n), np.arange(n - 2)])
    e_j = np.concatenate([(np.arange(n) + 1) % n, np.arange(n - 2) + 2])
    E = len(e_i)
    rel = np.stack([gt[j] @ np.linalg.inv(gt[i]) for i, j in zip(e_i, e_j)])
    pad = pad_e - E
    f32 = np.float32
    return dict(
        v_R=est[:, :3, :3].astype(f32), v_t=est[:, :3, 3].astype(f32), v_s=np.ones(n, f32),
        v_fixed=np.arange(n) == 0, v_mask=np.ones(n, bool),
        e_i=np.concatenate([e_i, np.zeros(pad)]).astype(np.int32),
        e_j=np.concatenate([e_j, np.zeros(pad)]).astype(np.int32),
        e_R=np.concatenate([rel[:, :3, :3], np.tile(np.eye(3), (pad, 1, 1))]).astype(f32),
        e_t=np.concatenate([rel[:, :3, 3], np.zeros((pad, 3))]).astype(f32),
        e_s=np.ones(pad_e, f32), e_mask=np.arange(pad_e) < E,
        e_weight=(np.arange(pad_e) < E).astype(f32),
    ), gt


def _two_view_problem(K, n_slots: int = 2048, n_valid: int = 300, n_out: int = 90, seed: int = 6):
    """Matched points of two keyframes under a known rigid motion, pixel noise,
    gross 3-D outliers among the valid matches, in the 2048 feature slots the
    loop closer hands the solver."""
    rng = np.random.default_rng(seed)
    n = n_slots
    pts2 = np.stack([rng.uniform(-12, 12, n), rng.uniform(-3, 3, n), rng.uniform(5, 40, n)], -1)
    w = np.array([0.05, 0.3, -0.02])
    th = np.linalg.norm(w)
    Wx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    R = np.eye(3) + np.sin(th) / th * Wx + (1 - np.cos(th)) / th**2 * (Wx @ Wx)
    t = np.array([2.0, 0.3, -1.0])
    pts1 = pts2 @ R.T + t

    def proj(P):
        return np.stack([K.fx * P[:, 0] / P[:, 2] + K.cx, K.fy * P[:, 1] / P[:, 2] + K.cy], -1)

    uv1 = proj(pts1) + rng.normal(0, 0.5, (n, 2))
    uv2 = proj(pts2) + rng.normal(0, 0.5, (n, 2))
    pts1[rng.choice(n_valid, n_out, replace=False)] += rng.uniform(2, 6, (n_out, 3))
    s2_1 = 1.44 ** rng.integers(0, 4, n)
    s2_2 = 1.44 ** rng.integers(0, 4, n)
    arrays = [a.astype(np.float32) for a in (pts1, pts2, uv1, uv2, s2_1, s2_2)]
    return arrays, np.arange(n) < n_valid, R, t


def _loop_programs(torch, dev, cfg, pairs_np, timing) -> None:
    """Phase 5: the loop stage's device programs on the card against the CPU.
    pairs_np: the rendered stereo pairs, indexable by the frames in BOW_FRAMES."""
    from slam_framework_torch.bow import vocabulary as bow_vocab
    from slam_framework_torch.optim import global_ba, pose_graph
    from slam_framework_torch.pipeline.frame import StereoFrontend
    from slam_framework_torch.solvers import sim3solver
    from slam_framework_torch.tools import ba_synthetic

    cpu = torch.device("cpu")
    torch.cuda.reset_peak_memory_stats(dev)

    def centres(R, t, s):
        return -torch.einsum("nji,nj->ni", R.cpu(), t.cpu() / s.cpu()[:, None]).numpy()

    # ---- vocabulary descent of real bench frames' descriptors
    vocab = bow_vocab.load(bow_vocab.SHIPPED_VOCABULARY)
    tab_dev, tab_cpu = vocab.device_tables(dev), vocab.device_tables(cpu)
    frontend = StereoFrontend(cfg)
    n_words = 0
    for f in BOW_FRAMES:
        fd = frontend(*(torch.from_numpy(img).to(dev) for img in pairs_np[f]))

        def run_bow(desc=fd.desc, valid=fd.valid, tab=tab_dev):
            return bow_vocab.transform(tab, desc, valid, vocab.depth, vocab.k)

        got = run_bow()
        want = run_bow(fd.desc.cpu(), fd.valid.cpu(), tab_cpu)
        if not _equal_runs(torch, got, run_bow()):
            _fail(f"vocabulary.transform: two runs on the card differ (frame {f})")
        for g, w, name in zip(got, want, ("word ids", "groups", "weights")):
            if not torch.equal(g.cpu(), w):
                _fail(f"vocabulary.transform: {name} differ between the card and the CPU on frame {f}: "
                      f"{int((g.cpu() != w).sum())} of {w.numel()}")
        n_words += int((want[0] >= 0).sum())
    print(f"vocabulary.transform card vs cpu ({vocab.num_nodes} nodes, k={vocab.k}, depth={vocab.depth}; bench "
          f"frames {BOW_FRAMES}, {fd.desc.shape[0]} descriptors each, {n_words} valid): word ids, groups and "
          f"weights exactly equal, two card runs bit-equal; " + _timed(torch, timing, "per frame", run_bow), flush=True)

    # ---- Sim3 RANSAC on a synthetic two-view set, the same index sets on both sides
    K = frontend.K
    arrays, mask, R_true, t_true = _two_view_problem(K)
    sets = sim3solver.sample_index_sets(torch.from_numpy(mask), 256, torch.Generator().manual_seed(7))

    def run_sim3(device=dev):
        args = [torch.from_numpy(a).to(device) for a in arrays] + [torch.from_numpy(mask).to(device)]
        return sim3solver.solve_sim3_ransac(*args, K, sets, fix_scale=True)

    got, want = run_sim3(), run_sim3(cpu)
    if not _equal_runs(torch, got, run_sim3()):
        _fail("solve_sim3_ransac: two runs on the card differ")
    dR = float((got.R.cpu() - want.R).abs().max())
    dt = float((got.t.cpu() - want.t).abs().max())
    flips = int((got.inliers.cpu() != want.inliers).sum())
    print(f"solve_sim3_ransac card vs cpu ({int(mask.sum())} matches in {len(mask)} slots, 256 hypotheses, the same "
          f"index sets): R differs by {dR:.3e}, t by {dt:.3e} (tolerance {SIM3_TOL}), {flips} inlier flags differ (at "
          f"most {SIM3_INLIER_FLIPS_MAX}), {int(got.n_inliers)} inliers, R {float(np.abs(got.R.cpu().numpy() - R_true).max()):.2e} "
          f"and t {float(np.abs(got.t.cpu().numpy() - t_true).max()):.2e} from the truth, two card runs bit-equal; "
          + _timed(torch, timing, "per attempt", run_sim3), flush=True)
    if not (dR <= SIM3_TOL and dt <= SIM3_TOL) or flips > SIM3_INLIER_FLIPS_MAX or not bool(got.ok):
        _fail("solve_sim3_ransac disagrees between the card and the CPU")

    # ---- pose graph on a drifted ring
    ring, gt = _ring_problem()

    def ring_problem(device):
        return pose_graph.PoseGraphProblem(**{k: torch.from_numpy(v).to(device) for k, v in ring.items()})

    prob = ring_problem(dev)

    def run_pg():
        return pose_graph.optimize(prob, iters=cfg.loop.essential_graph_iters)

    got = run_pg()
    want = pose_graph.optimize(ring_problem(cpu), iters=cfg.loop.essential_graph_iters)
    if not _equal_runs(torch, got, run_pg()):
        _fail("pose_graph.optimize: two runs on the card differ")
    c_got, c_want = centres(got.v_R, got.v_t, got.v_s), centres(want.v_R, want.v_t, want.v_s)
    c_gt = -np.einsum("nji,nj->ni", gt[:, :3, :3], gt[:, :3, 3])
    c_0 = centres(prob.v_R, prob.v_t, prob.v_s)
    centre_err = float(np.linalg.norm(c_got - c_want, axis=1).max())

    def rmse(c):
        return float(np.sqrt(np.mean(np.sum((c - c_gt) ** 2, axis=1))))

    print(f"pose_graph.optimize card vs cpu (ring of {len(gt)} vertices, {int(ring['e_mask'].sum())} edges in "
          f"{len(ring['e_mask'])} slots, {cfg.loop.essential_graph_iters} GN x 60 PCG): camera centres differ by "
          f"{centre_err:.3e} m (tolerance {POSE_GRAPH_CENTRE_TOL_M}); cost {float(got.initial_cost):.6e} -> "
          f"{float(got.final_cost):.6e} (cpu {float(want.final_cost):.6e}); RMSE of the centres against the truth "
          f"{rmse(c_0):.4f} m -> {rmse(c_got):.4f} m; two card runs bit-equal; "
          + _timed(torch, timing, "per optimisation", run_pg, reps=2), flush=True)
    if not centre_err <= POSE_GRAPH_CENTRE_TOL_M or not float(got.final_cost) < 1e-3 * float(got.initial_cost):
        _fail("pose_graph.optimize disagrees between the card and the CPU, or did not reduce its cost")

    # ---- global BA at the size of the bench map at its closure
    syn = ba_synthetic.build_global_problem(seed=12)
    Kba = ba_synthetic.K_SYNTHETIC

    def gba_problem(device):
        return global_ba.GlobalBAProblem(**{k: torch.from_numpy(v).to(device) for k, v in syn.arrays.items()})

    gprob = gba_problem(dev)

    def run_gba():
        return global_ba.optimize_global(gprob, Kba)

    got = run_gba()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = global_ba.optimize_global(gba_problem(cpu), Kba)
    cpu_s = time.perf_counter() - t0
    if not _equal_runs(torch, got, run_gba()):
        _fail("optimize_global: two runs on the card differ")

    def cam_centres(poses):
        poses = poses.cpu().numpy().astype(np.float64)
        return -np.einsum("cji,cj->ci", poses[:, :3, :3], poses[:, :3, 3])

    n_cams = syn.poses_true.shape[0]
    centre_err = float(np.linalg.norm(cam_centres(got.cam_pose) - cam_centres(want.cam_pose), axis=1).max())
    truth_err = float(np.linalg.norm(cam_centres(got.cam_pose)[:n_cams]
                                     - cam_centres(torch.from_numpy(syn.poses_true)), axis=1).max())
    chi2_rel = abs(float(got.total_chi2) - float(want.total_chi2)) / float(want.total_chi2)
    a = syn.arrays
    print(f"optimize_global card vs cpu ({n_cams} cameras, {syn.pts_true.shape[0]} points, {int(a['obs_mask'].sum())} "
          f"observations in {a['cam_pose'].shape[0]} / {a['pt_pos'].shape[0]} / {a['obs_cam'].shape[0]} slots, "
          f"{a['cam_obs_slots'].shape[1]} per camera; 5 + 10 LM x 60 PCG; the loop closer's call runs 10 LM): camera "
          f"centres differ by {centre_err:.3e} m (tolerance {GBA_CENTRE_TOL_M}), total chi2 {float(got.total_chi2):.3f} "
          f"vs {float(want.total_chi2):.3f} (relative {chi2_rel:.2e}, tolerance {GBA_CHI2_REL_TOL}), inlier masks "
          f"differ on {int((got.obs_inlier.cpu() != want.obs_inlier).sum())} observations, worst camera "
          f"{truth_err:.4f} m from the truth, two card runs bit-equal; cpu {cpu_s:.2f} s; "
          + _timed(torch, timing, "per global BA", run_gba, reps=2, graph=True)
          + f"; peak device memory of this phase {torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB", flush=True)
    if not centre_err <= GBA_CENTRE_TOL_M or not chi2_rel <= GBA_CHI2_REL_TOL or not truth_err < 0.03:
        _fail("optimize_global disagrees between the card and the CPU")


def _reloc_problem(K, n_slots: int, n_valid: int = 300, seed: int = 8):
    """A lost frame's matched set at relocalization size: world points seen from
    a known pose, pixel noise, 30% gross pixel outliers among the matches,
    stereo back-projections (depth noise growing as z^2/bf) on 90% of them,
    masked slots behind."""
    rng = np.random.default_rng(seed)
    n = n_valid
    pts = np.stack([rng.uniform(-15, 15, n), rng.uniform(-3, 3, n), rng.uniform(4, 40, n)], -1)
    w, t = np.array([0.02, 0.4, -0.01]), np.array([1.5, -0.2, 3.0])
    th = np.linalg.norm(w)
    Wx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    R = np.eye(3) + np.sin(th) / th * Wx + (1 - np.cos(th)) / th**2 * (Wx @ Wx)
    Xc = pts @ R.T + t
    uv = np.stack([K.fx * Xc[:, 0] / Xc[:, 2] + K.cx, K.fy * Xc[:, 1] / Xc[:, 2] + K.cy], -1)
    uv += rng.normal(0, 0.5, (n, 2))
    out = rng.choice(n, int(0.3 * n), replace=False)
    uv[out] += rng.uniform(20, 120, (len(out), 2)) * rng.choice([-1, 1], (len(out), 2))
    z = Xc[:, 2] + rng.normal(0, 1, n) * 0.05 * Xc[:, 2] ** 2 / K.bf
    pts_c = np.stack([(uv[:, 0] - K.cx) * z / K.fx, (uv[:, 1] - K.cy) * z / K.fy, z], -1)
    pad = n_slots - n

    def slots(a):
        return np.concatenate([a, np.zeros((pad,) + a.shape[1:])]).astype(np.float32)

    inv_s2 = (1.0 / 1.44 ** rng.integers(0, 8, n_slots)).astype(np.float32)
    mask = np.arange(n_slots) < n
    mask3 = mask.copy()
    mask3[rng.choice(n, n // 10, replace=False)] = False  # no stereo depth
    return slots(pts), slots(pts_c), slots(uv), inv_s2, mask, mask3, R, t


def _reloc_programs(torch, dev, cfg, timing) -> None:
    """Phase 5b: the relocalization solvers on the card against the CPU."""
    from slam_framework_torch.pipeline.frame import StereoFrontend
    from slam_framework_torch.solvers import pnp, sim3solver

    cpu = torch.device("cpu")
    K = StereoFrontend(cfg).K
    n_slots = cfg.capacity.max_features
    pts_w, pts_c, uv, inv_s2, mask, mask3, R_true, t_true = _reloc_problem(K, n_slots)
    gen = torch.Generator().manual_seed(11)
    sets3 = sim3solver.sample_index_sets(torch.from_numpy(mask3), 256, gen, set_size=3)
    sets6 = sim3solver.sample_index_sets(torch.from_numpy(mask), 256, gen, set_size=pnp.MIN_SET)

    def on(device, *arrays):
        return [torch.from_numpy(a).to(device) for a in arrays]

    def run3(device=dev):
        return pnp.solve_pnp3d_ransac(*on(device, pts_w, pts_c, uv, inv_s2, mask3), K, sets3, min_inliers=6)

    def run2(device=dev):
        return pnp.solve_pnp_ransac(*on(device, pts_w, uv, inv_s2, mask), K, sets6, min_inliers=10)

    for name, run, n_m in (("solve_pnp3d_ransac", run3, int(mask3.sum())), ("solve_pnp_ransac", run2, int(mask.sum()))):
        got, want = run(), run(cpu)
        if not _equal_runs(torch, got, run()):
            _fail(f"{name}: two runs on the card differ")
        dR = float((got.pose[:3, :3].cpu() - want.pose[:3, :3]).abs().max())
        dt = float((got.pose[:3, 3].cpu() - want.pose[:3, 3]).abs().max())
        flips = int((got.inliers.cpu() != want.inliers).sum())
        pose = got.pose.cpu().numpy()
        print(f"{name} card vs cpu ({n_m} matches in {n_slots} slots, 30% outliers, 256 hypotheses, the same index "
              f"sets): R differs by {dR:.3e} (tolerance {PNP_R_TOL[name]}), t by {dt:.3e} m (tolerance {PNP_T_TOL_M}), "
              f"{flips} inlier flags differ (at most {PNP_INLIER_FLIPS_MAX}), {int(got.n_inliers)} inliers (cpu "
              f"{int(want.n_inliers)}), R {float(np.abs(pose[:3, :3] - R_true).max()):.2e} and t "
              f"{float(np.abs(pose[:3, 3] - t_true).max()):.2e} m from the truth, two card runs bit-equal; "
              + _timed(torch, timing, "per call", run), flush=True)
        if not (dR <= PNP_R_TOL[name] and dt <= PNP_T_TOL_M) or flips > PNP_INLIER_FLIPS_MAX or not bool(got.ok):
            _fail(f"{name} disagrees between the card and the CPU")


def _ate_tracked(trajectory, system, world):
    """ATE over the tracked frames alone (SE3-aligned) and their count."""
    records = system.tracker.records
    tracked = [i for i, r in enumerate(records) if not r.lost]
    est = system.frame_poses()[tracked]
    gt = world.poses[[records[i].frame_id for i in tracked]]
    return trajectory.ate_rmse(est, gt, align="se3"), len(tracked)


def _state_on_card(system) -> bool:
    tracker = system.tracker
    store = tracker.local_mapper.kf_store
    tensors = list(tracker._dstate) + list(tracker._block) + [store.packs, store.descs]
    if system.loop_closer is not None:
        tensors += list(system.loop_closer._tables)
    return all(t.device.type == "cuda" for t in tensors)


def _steps(report) -> list:
    """A relocalizer's last_report with the BoW match rows counted."""
    return [{k: (len(v) if k == "rows" else v) for k, v in step.items()} for step in report]


def _blackout_run(torch, dev, cfg, world, pairs, timing, fast_cuda, trajectory, SlamSystem, snap_path: str) -> dict:
    """Phase 7: the bench world with frames 110-112 blank, relocalization and the loop.
    The map, the relocalizer's generator and the features just before the first
    attempt after the blackout are kept for the replay."""
    from slam_framework_torch.io import checkpoint

    gray = torch.full_like(pairs[0], 90)
    feed = [gray if f in BLACKOUT else pairs[f] for f in range(N_FRAMES)]
    system = SlamSystem(cfg, sensor="stereo", sync_every=SYNC, device=dev)
    reloc = system.tracker.relocalizer
    tried = {}
    inner = reloc.try_relocalize

    def recording(fd_host):
        fid = system.tracker.frame_id
        snap = None
        if fid > BLACKOUT[-1] and "snap" not in tried:
            t0 = time.perf_counter()
            checkpoint.save_map(snap_path, system.arena, system.tracker.records, system.vocab)
            snap = tried["snap"] = {"path": snap_path, "gen": reloc._gen.get_state(), "frame": fid,
                                    "fd": {k: v.copy() for k, v in fd_host.items()}, "pair": feed[fid],
                                    "save_s": time.perf_counter() - t0}
        got = inner(fd_host)
        steps = _steps(reloc.last_report)
        tried.setdefault("reports", []).append((fid, steps))
        if snap is not None:
            snap["live"] = (None if got is None else (int(got.kf), int(got.n_inliers)), steps)
        if got is not None and "fd" not in tried:
            tried["fd"] = fd_host
        return got

    reloc.try_relocalize = recording
    torch.cuda.synchronize()
    fast_cuda.launches = 0
    t0 = time.perf_counter()
    for f in range(N_FRAMES):
        system.track_stereo_device(feed[f], world.timestamps[f])
    system.tracker.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fast_cuda.launches
    stats = system.shutdown()
    records = system.tracker.records
    lost = [r.frame_id for r in records if r.lost]
    events = [e for e in system.tracker.metrics.records if e.get("relocalized")]
    after = [e for e in events if e["frame_id"] > BLACKOUT[-1]]
    ate, n_tracked = _ate_tracked(trajectory, system, world)
    closer = system.loop_closer
    timers = system.tracker.timers.summary()
    rl = timers.get("relocalize", {"total_ms": float("nan"), "count": 0})
    snap_ms = 1e3 * tried.get("snap", {}).get("save_s", 0.0)
    print(f"blackout run (frames {BLACKOUT[0]}-{BLACKOUT[-1]} blank): {N_FRAMES} frames in {wall:.3f} s = "
          f"{N_FRAMES / wall:.3f} frames/s; lost {len(lost)} frames {lost} (reference on the CPU: {REF_LOST}, bound "
          f"{REF_LOST + SYNC}); relocalized: "
          + (", ".join(f"frame {e['frame_id']} against keyframe {e['reloc_kf']} with {e['inliers']} inliers"
                       for e in events) or "never")
          + f"; {reloc.n_attempts} attempts, {rl['total_ms']:.1f} ms in all, {snap_ms:.1f} ms of it saving the replay's "
          f"snapshot, so {(rl['total_ms'] - snap_ms) / max(rl['count'], 1):.1f} ms per attempt (front-end included); "
          f"resets {stats['resets']}; "
          f"keyframes {stats['keyframes']}, loops closed {stats['loops_closed']} (edges "
          f"{[(int(a), int(b)) for a, b, _ in closer.loop_edges]}, {closer.n_sim3_attempts} Sim3 attempts), last "
          f"report {json.dumps(closer.last_report, default=float)}; ATE over the {n_tracked} tracked frames "
          f"{ate:.4f} m (bound {ATE_BLACKOUT_BOUND_M} m); fast_nms launches {launches}", flush=True)
    print(f"blackout run stage timers: {json.dumps(timers)}", flush=True)
    print("relocalization attempts, per frame and candidate tried (BoW matches and the inliers of the RANSAC, "
          "the motion-only BA and the guided retry): " + json.dumps(tried.get("reports", [])), flush=True)
    if not records[BLACKOUT[0]].lost:
        _fail("tracking was not lost at the blackout")
    if not after:
        _fail("no frame after the blackout relocalized")
    if stats["resets"]:
        _fail(f"{stats['resets']} resets in the blackout run")
    if stats["loops_closed"] < 1 or "gba" not in closer.last_report:
        _fail(f"no loop closed with its global BA merged after the blackout: {closer.last_report}")
    if len(lost) > REF_LOST + SYNC:
        _fail(f"{len(lost)} lost frames, more than the reference's {REF_LOST} + {SYNC}")
    if not ate <= ATE_BLACKOUT_BOUND_M:
        _fail(f"ATE over the tracked frames {ate} m above the bound {ATE_BLACKOUT_BOUND_M} m")
    if launches != N_FRAMES:
        _fail(f"fast_nms launches {launches} != one per frame over {N_FRAMES} frames in the blackout run")
    if not _state_on_card(system):
        _fail("a tracker state tensor is off the CUDA device in the blackout run")
    # one relocalization attempt alone: the first successful lost frame's
    # features against the final map
    fd = tried["fd"]
    kernels, copies = _count_launches(torch, lambda: inner(fd))
    ms = timing.event_ms(lambda: inner(fd), reps=3)
    print(f"one relocalization attempt (frame {after[0]['frame_id']}'s features against the final map, front-end "
          f"excluded): {ms:.2f} ms between events, {kernels} kernels + {copies} copies/memsets", flush=True)
    return {"launches": launches, "snap": tried["snap"]}


def _reloc_replay(torch, dev, cfg, SlamSystem, snap: dict) -> None:
    """Phase 7, replay: the first attempt after the blackout again, from the map
    saved just before it, on the card and on the CPU, from the live attempt's
    features and from the frame's pixels through each device's own front-end."""
    out = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        for source in ("features", "pixels"):
            system = SlamSystem(cfg, sensor="stereo", sync_every=SYNC, device=device)
            system.load_map(snap["path"])
            tracker = system.tracker
            reloc = tracker.relocalizer
            reloc._gen.set_state(snap["gen"])
            t0 = time.perf_counter()
            if source == "features":
                got = reloc.try_relocalize(snap["fd"])
                result = None if got is None else (int(got.kf), int(got.n_inliers))
                pose = None if got is None else got.pose
            else:
                tracker.frame_id = snap["frame"]
                tracker._track_lost(snap["pair"].to(device), 0.0)
                rec = tracker.records[-1]
                event = tracker.metrics.records[-1] if not rec.lost else {}
                result = None if rec.lost else (int(rec.ref_kf), int(event.get("inliers", -1)))
                pose = rec.pose
            out[(name, source)] = (result, _steps(reloc.last_report), time.perf_counter() - t0, pose)
    live_result, live_steps = snap["live"]
    print(f"relocalization replay of frame {snap['frame']} (the map saved just before the live attempt, the same "
          f"generator state; result = (keyframe, inliers); per candidate: BoW matches, RANSAC / motion-only BA / "
          f"guided-retry inliers): live on the card {live_result} {json.dumps(live_steps)}", flush=True)
    for (name, source), (result, steps, secs, _) in out.items():
        print(f"  replay on the {name} from the {source}: {result} {json.dumps(steps)} ({secs:.2f} s)", flush=True)

    def first_difference(a, b):
        for i, (x, y) in enumerate(zip(a, b)):
            for key in ("kf", "rows", "ransac", "pose_opt", "guided"):
                if x.get(key) != y.get(key):
                    return f"candidate {i} (keyframe {x.get('kf')}), stage {key}: {x.get(key)} vs {y.get(key)}"
        return None if len(a) == len(b) else f"{len(a)} vs {len(b)} candidates"

    for a, b in ((("card", "features"), ("cpu", "features")), (("card", "pixels"), ("cpu", "pixels")),
                 (("card", "features"), ("card", "pixels"))):
        diff = first_difference(out[a][1], out[b][1])
        pa, pb = out[a][3], out[b][3]
        poses = ("" if pa is None or pb is None else
                 f"; the poses differ by {float(np.abs(pa[:3, :3] - pb[:3, :3]).max()):.2e} in R and "
                 f"{float(np.abs(pa[:3, 3] - pb[:3, 3]).max()):.2e} m in t")
        print(f"  {a[0]} from the {a[1]} vs {b[0]} from the {b[1]}: "
              + ("the same candidates and counts at every stage" if diff is None else f"first part at {diff}")
              + poses, flush=True)
    diff = first_difference(live_steps, out[("card", "features")][1])
    print("  live vs the card's replay from the features: "
          + ("the same at every stage (the snapshot holds the state the attempt used)" if diff is None
             else f"first part at {diff}"), flush=True)


def _resume_run(torch, dev, cfg, world, pairs, fast_cuda, trajectory, SlamSystem, path: str, save_s: float) -> dict:
    """Phase 8: load the saved main-path map into a fresh system, localize."""
    from slam_framework_torch.pipeline.tracker import TrackingState

    system = SlamSystem(cfg, sensor="stereo", sync_every=SYNC, device=dev)
    t0 = time.perf_counter()
    system.load_map(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if system.tracking_state != TrackingState.LOST:
        _fail(f"state {system.tracking_state} after load_map, not LOST")
    n_saved = len(system.tracker.records)
    saved = system.tracker.trajectory_poses()  # the saved records in the map's corrected world
    kfs = system.arena.n_valid_kfs
    system.activate_localization_mode()
    torch.cuda.synchronize()
    fast_cuda.launches = 0
    t0 = time.perf_counter()
    for f in RESUME_FRAMES:
        system.track_stereo_device(pairs[f], world.timestamps[f])
    system.tracker.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fast_cuda.launches
    new = system.tracker.records[n_saved:]
    tracked = [(r, f) for r, f in zip(new, RESUME_FRAMES) if not r.lost]
    first = next((i for i, r in enumerate(new) if not r.lost), None)

    def centre(T):
        return -T[:3, :3].T.astype(np.float64) @ T[:3, 3].astype(np.float64)

    # the map's world aligned to the truth's over these frames, through the saved trajectory
    c_saved = np.stack([centre(saved[f]) for f in RESUME_FRAMES])
    c_true = np.stack([centre(world.poses[f]) for f in RESUME_FRAMES])
    R, t, _ = trajectory.umeyama_alignment(c_saved, c_true, with_scale=False)
    errs = [float(np.linalg.norm(R @ centre(r.pose) + t - centre(world.poses[f]))) for r, f in tracked]
    to_saved = [round(float(np.linalg.norm(centre(r.pose) - centre(saved[f]))), 3) for r, f in tracked]
    saved_errs = [round(float(e), 3) for e in np.linalg.norm(c_saved @ R.T + t - c_true, axis=1)]
    events = [e for e in system.tracker.metrics.records if e.get("relocalized")]
    print(f"resume run: map file {os.path.getsize(path) / 2**20:.1f} MiB, saved in {save_s:.2f} s, loaded in "
          f"{load_s:.2f} s ({n_saved} records, {kfs} keyframes); localization mode over bench frames "
          f"{RESUME_FRAMES[0]}-{RESUME_FRAMES[-1]} in {wall:.3f} s: first tracked frame #{first} of the 30, "
          f"relocalizations " + ", ".join(f"frame {e['frame_id']} against keyframe {e['reloc_kf']} with "
                                          f"{e['inliers']} inliers" for e in events)
          + f"; {len(tracked)} tracked; keyframes {system.arena.n_valid_kfs} (was {kfs}); worst camera centre "
          f"{max(errs) if errs else float('nan'):.4f} m from the truth in the aligned world (tolerance "
          f"{RESUME_CENTRE_TOL_M}; per tracked frame {[round(e, 3) for e in errs]}; the saved trajectory's own "
          f"{saved_errs}); distance to the saved trajectory per frame {to_saved}; fast_nms launches {launches}",
          flush=True)
    if first is None or first > 2:
        _fail("none of the first three frames relocalized against the loaded map")
    if len(tracked) < RESUME_MIN_TRACKED:
        _fail(f"only {len(tracked)} of 30 frames tracked against the loaded map")
    if system.arena.n_valid_kfs != kfs:
        _fail("localization mode changed the keyframe count")
    if not max(errs) <= RESUME_CENTRE_TOL_M:
        _fail(f"a tracked camera centre is {max(errs)} m from the truth in the aligned world")
    if launches != len(RESUME_FRAMES):
        _fail(f"fast_nms launches {launches} != one per frame over {len(RESUME_FRAMES)} frames")
    if not _state_on_card(system):
        _fail("a tracker state tensor is off the CUDA device in the resume run")
    return {"launches": launches}


def _sensor_run(torch, dev, cfg, world, frames, sensor: str, n_frames: int, fast_cuda, trajectory,
                SlamSystem) -> dict:
    """Phases 9 and 10: the bench frames through an RGB-D or a monocular SlamSystem.
    frames[f] is (left, right, depth) on the host."""
    scfg = dataclasses.replace(cfg, sensor=sensor)
    ref = REF_RGBD if sensor == "rgbd" else REF_MONO

    def feed(system, f):
        left, _, depth = frames[f]
        if sensor == "rgbd":
            system.track_rgbd(left, depth, world.timestamps[f])
        else:
            system.track_monocular(left, world.timestamps[f])

    warm = SlamSystem(scfg, sync_every=SYNC, device=dev)
    for f in range(SYNC + 1):
        feed(warm, f)
    warm.shutdown()
    del warm
    system = SlamSystem(scfg, sync_every=SYNC, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fast_cuda.launches = 0
    t0 = time.perf_counter()
    for f in range(n_frames):
        feed(system, f)
    system.tracker.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fast_cuda.launches
    peak = torch.cuda.max_memory_allocated(dev)
    stats = system.shutdown()
    records = system.tracker.records
    tracked = [i for i, r in enumerate(records) if not r.lost]
    fids = [records[i].frame_id for i in tracked]
    lost = [r.frame_id for r in records if r.lost]
    untracked = n_frames - len(tracked)
    align = "se3" if sensor == "rgbd" else "sim3"
    est = system.frame_poses()[tracked]
    if not np.isfinite(est).all():
        _fail(f"{sensor} run: non-finite poses")
    ate = trajectory.ate_rmse(est, world.poses[fids], align=align)
    closer = system.loop_closer
    mapper = stats["mapper"]
    init = getattr(system.tracker, "last_init", None)
    name = "RGB-D" if sensor == "rgbd" else "monocular"
    print(f"{name} run: {n_frames} frames in {wall:.3f} s = {n_frames / wall:.3f} frames/s, "
          + (f"initialized at frame {init['frame']} against frame {init['ref_frame']} with {init['points']} points, "
             f"median depth {init['median_depth']:.6f} after it; " if init else "")
          + f"ATE ({align.upper()}-aligned, over the {len(tracked)} tracked frames) {ate:.4f} m (reference on the "
          f"CPU {ref['ate_m']} m, bound {2 * ref['ate_m']} m), lost {len(lost)} {lost}, untracked {untracked}, "
          f"resets {stats['resets']}, keyframes {stats['keyframes']} (+ {mapper['culled_keyframes']} culled), map "
          f"points {stats['map_points']}, BAs applied {mapper['ba_applied']} / aborted {stats['ba_aborts']}, "
          f"triangulated points {mapper['triangulated']}, loops closed {stats['loops_closed']} (edges "
          f"{[(int(a), int(b)) for a, b, _ in closer.loop_edges]}, {closer.n_sim3_attempts} Sim3 attempts), last "
          f"report {json.dumps(closer.last_report, default=float)}; fast_nms launches {launches}, peak device "
          f"memory {peak / 2**20:.1f} MiB", flush=True)
    print(f"{name} run stage timers: {json.dumps(system.tracker.timers.summary())}", flush=True)
    missed = len(lost) if sensor == "rgbd" else untracked
    allowed = (ref["lost"] if sensor == "rgbd" else ref["untracked"]) + SYNC
    if missed > allowed:
        _fail(f"{name} run: {missed} {'lost' if sensor == 'rgbd' else 'untracked'} frames, more than {allowed}")
    if stats["loops_closed"] < ref["loops"]:
        _fail(f"{name} run: {stats['loops_closed']} loops closed, fewer than the reference's {ref['loops']}")
    if not ate <= 2 * ref["ate_m"]:
        _fail(f"{name} run: ATE {ate} m above the bound {2 * ref['ate_m']} m")
    if launches != n_frames:
        _fail(f"{name} run: fast_nms launches {launches} != one per frame over {n_frames} frames")
    if not _state_on_card(system):
        _fail(f"{name} run: a tracker state tensor is off the CUDA device")
    return {"launches": launches}


_WORLD = None  # the bench world of a render worker


def _render_init() -> None:
    global _WORLD
    from slam_framework_torch.config import SlamConfig
    from slam_framework_torch.tools.track_bench_world import bench_world

    _WORLD = bench_world(SlamConfig(), num_frames=N_FRAMES)


def _render(f: int):
    """Bench frame f: the left image and its depth from one ray cast, the right image."""
    left, depth = _WORLD.rgbd_pair(f)
    return left, _WORLD.render(f, right=True), depth


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False")
    from slam_framework_torch import BUILD_DIR, native
    from slam_framework_torch.config import SlamConfig
    from slam_framework_torch.io import trajectory
    from slam_framework_torch.ops import fast_cuda, pyramid
    from slam_framework_torch.system import SlamSystem
    from slam_framework_torch.tools.track_bench_world import bench_world
    from slam_framework_torch.utils import cuda_timing as timing

    print(timing.card_line(), flush=True)  # the card's name and power limit, as nvidia-smi gives them
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # ---- 2. build
    t0 = time.perf_counter()
    so = fast_cuda.build()
    print(f"build: {so} in {time.perf_counter() - t0:.2f} s", flush=True)
    # without it the arena silently takes its numpy loops on the host
    print(f"native arena library built: {native.load_arena_ops() is not None}", flush=True)

    # ---- 3. kernel vs plain on the card
    cfg = SlamConfig()
    t0 = time.perf_counter()
    world = bench_world(cfg, num_frames=N_FRAMES)
    with multiprocessing.get_context("spawn").Pool(RENDER_PROCS, initializer=_render_init) as pool:
        frames = pool.map(_render, range(N_FRAMES), chunksize=5)
    pairs_np = [(left, right) for left, right, _ in frames]
    print(f"world: {N_FRAMES} frames rendered (left image + its depth, right image) in "
          f"{time.perf_counter() - t0:.1f} s by {RENDER_PROCS} processes", flush=True)

    def level_images(img):
        return pyramid.build_pyramid(torch.from_numpy(img).to(dev).float(), cfg.orb.num_levels, cfg.orb.scale_factor)

    levels = level_images(pairs_np[0][0]) + level_images(pairs_np[0][1])
    # the 8 level images an RGB-D frame (bench frame 0) and a monocular frame
    # (bench frame 1, the reference's init frame) hand to the kernel
    levels_rgbd, levels_mono = level_images(pairs_np[0][0]), level_images(pairs_np[1][0])
    rng = np.random.default_rng(7)
    odd = [torch.from_numpy(rng.integers(0, 256, s).astype(np.float32)).to(dev)
           for s in ((75, 140), (7, 5), (200, 17), (61, 99))]
    odd[-1] = odd[-1] * 0.37 - 47.3  # values of both signs that are not whole numbers
    max_err = 0.0
    for what, imgs in (("frame 0, 8 levels x 2 images", levels), ("RGB-D frame 0, 8 levels", levels_rgbd),
                       ("monocular frame 1, 8 levels", levels_mono), ("odd shapes", odd)):
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

    def frame8_call():
        return fast_cuda.fast_nms_strength_levels(levels_rgbd)

    pixels8 = sum(t.numel() for t in levels_rgbd)
    bound8, bound8_by = timing.bound_ms(pixels8 * fast_cuda.BYTES_PER_PIXEL, pixels8 * fast_cuda.OPS_PER_PIXEL)
    kernel8_ms = timing.device_ms(frame8_call)
    flushed8_ms = timing.device_ms_flushed(frame8_call, timing.l2_flusher(dev))
    host8_ms = timing.host_ms(frame8_call)
    plain8_ms = timing.device_ms(lambda: [fast_cuda.fast_nms_strength_plain(t) for t in levels_rgbd], calls=5)
    print(
        f"fast_nms per RGB-D / monocular frame ({len(levels_rgbd)} images, {pixels8} px, one launch): device "
        f"{kernel8_ms:.5f} ms L2-warm, {flushed8_ms:.5f} ms L2-flushed; bound {bound8:.5f} ms by {bound8_by} "
        f"({100 * bound8 / kernel8_ms:.1f}% of it reached); host {host8_ms:.5f} ms per call; plain "
        f"{plain8_ms:.4f} ms device",
        flush=True,
    )

    # ---- 4. mapper programs on the card against the CPU
    _mapper_programs(torch, dev, cfg, world, pairs_np, timing)

    # ---- 5. loop programs on the card against the CPU
    _loop_programs(torch, dev, cfg, pairs_np, timing)

    # ---- 5b. relocalization programs on the card against the CPU
    _reloc_programs(torch, dev, cfg, timing)

    # ---- 6. main path
    pairs = [torch.from_numpy(np.stack([l, r])).to(dev) for l, r in pairs_np]
    torch.cuda.synchronize()
    warm = SlamSystem(cfg, sensor="stereo", sync_every=SYNC, device=dev)
    for f in range(SYNC + 1):
        warm.track_stereo_device(pairs[f], world.timestamps[f])
    warm.shutdown()
    del warm

    system = SlamSystem(cfg, sensor="stereo", sync_every=SYNC, device=dev)
    # the trajectory as it stood just before the loop correction rewrote the map
    before = {}
    correct_loop = system.loop_closer._correct_loop

    def recording_correct_loop(kf, cand):
        before.update(kf=kf, loop_kf=cand.kf, poses=system.tracker.trajectory_poses(),
                      frames=[r.frame_id for r in system.tracker.records])
        return correct_loop(kf, cand)

    system.loop_closer._correct_loop = recording_correct_loop
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
    timers = system.tracker.timers.summary()
    print(f"stage timers: {json.dumps(timers)}", flush=True)
    closer = system.loop_closer
    report = closer.last_report
    if stats["loops_closed"] < 1 or not before:
        _fail(f"no loop closed in {N_FRAMES} frames: {closer.n_sim3_attempts} Sim3 attempts, last report {report}")
    n_before = len(before["frames"])
    ate_before = trajectory.ate_rmse(before["poses"], world.poses[before["frames"]], align="se3")
    ate_prefix = trajectory.ate_rmse(est[:n_before], world.poses[:n_before], align="se3")
    loop_ms = timers.get("loop", {}).get("total_ms", float("nan"))
    print(
        f"loop stage: {stats['loops_closed']} loop closed at keyframe {before['kf']} (frame "
        f"{int(system.arena.kf_frame_id[before['kf']])}) against keyframe {before['loop_kf']}, after "
        f"{closer.n_sim3_attempts} Sim3 attempts; ATE over the {n_before} frames tracked before the closure "
        f"{ate_before:.4f} m just before it, {ate_prefix:.4f} m at the end; ATE over all {N_FRAMES} frames at the "
        f"end {ate:.4f} m; last report {json.dumps(report, default=float)}; {loop_ms:.1f} ms of the wall inside "
        f"the loop stage ({100 * loop_ms / (1e3 * wall):.1f}%)",
        flush=True,
    )
    if "gba" not in report:
        _fail(f"the global BA of the closure was not merged: {report}")
    if not _state_on_card(system):
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
    os.makedirs(BUILD_DIR, exist_ok=True)
    map_path = os.path.join(BUILD_DIR, "smoke_map.npz")
    t0 = time.perf_counter()
    system.save_map(map_path)
    save_s = time.perf_counter() - t0

    # ---- 7. blackout run, and the replay of its first attempt after the blackout
    blackout = _blackout_run(torch, dev, cfg, world, pairs, timing, fast_cuda, trajectory, SlamSystem,
                             os.path.join(BUILD_DIR, "smoke_blackout_map.npz"))
    _reloc_replay(torch, dev, cfg, SlamSystem, blackout["snap"])

    # ---- 8. resume run
    resume = _resume_run(torch, dev, cfg, world, pairs, fast_cuda, trajectory, SlamSystem, map_path, save_s)
    del pairs

    # ---- 9. RGB-D run
    rgbd = _sensor_run(torch, dev, cfg, world, frames, "rgbd", N_FRAMES, fast_cuda, trajectory, SlamSystem)

    # ---- 10. monocular run
    if MONO_FRAMES < N_FRAMES:
        print(f"monocular run: the first {MONO_FRAMES} of the {N_FRAMES} frames", flush=True)
    mono = _sensor_run(torch, dev, cfg, world, frames, "monocular", MONO_FRAMES, fast_cuda, trajectory, SlamSystem)
    print(f"smoke total: {time.perf_counter() - t_start:.1f} s", flush=True)

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
        "launches_blackout_run": blackout["launches"],
        "launches_resume_run": resume["launches"],
        "launches_rgbd_run": rgbd["launches"],
        "launches_mono_run": mono["launches"],
        "ms_8_images": kernel8_ms,
        "ms_8_images_l2_flushed": flushed8_ms,
        "plain_ms_8_images": plain8_ms,
        "bound_ms_8_images": bound8,
        "bound_by_8_images": bound8_by,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
