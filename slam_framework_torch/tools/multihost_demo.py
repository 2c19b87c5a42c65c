"""N spawned ranks run the distributed optimizers over a ProcessMesh; their
results are held against the single-rank optimizers.

    python -m slam_framework_torch.tools.multihost_demo --processes 2 [--device cpu]

Port of tools/multihost_demo.py. Every rank is a process of its own, joined by
`torch.distributed` (`parallel/multihost.initialize`: NCCL on CUDA with one GPU
per rank, the default, which raises with fewer GPUs than ranks; gloo when
--device cpu is given); every rank builds the same seeded problems and
runs, over the mesh of all ranks:
  - the round-robin sharded global BA (`dist_ba.optimize_global_sharded`);
  - the owner-keyed (covisibility segment) global BA;
  - the re-deal of point rows in one all_to_all (`map_shard.migrate_points`),
    which every rank checks row for row against a numpy re-deal;
  - the edge-sharded Sim3 pose graph (`dist_pose_graph.optimize_sharded`).
Rank 0 saves what came out (`ranks.npz` in --out, a temporary directory by
default). The parent meanwhile runs the single-rank optimizers on the same
problems, then prints one JSON line: the largest camera and vertex differences
from them, whether the migration landed, and `ok`.
The rendezvous is a file (`file://`, no port) unless --port is given.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from slam_framework_torch import resolve_device
from slam_framework_torch.geometry.projection import Intrinsics
from slam_framework_torch.optim import global_ba, pose_graph
from slam_framework_torch.optim.global_ba import GlobalBAProblem
from slam_framework_torch.optim.pose_graph import PoseGraphProblem

K_DEMO = Intrinsics(fx=100.0, fy=100.0, cx=64.0, cy=32.0, bf=50.0)
BA_ITERS = dict(iters_first=2, iters_second=3, cg_iters=25)
PG_ITERS = dict(iters=8, cg_iters=30)
TOL_M = 1e-3  # the bound of tests/test_multihost.py


def ba_problem(n_cams: int = 6, n_pts: int = 48) -> dict:
    """A small stereo BA problem (numpy fields of GlobalBAProblem), the same
    on every rank (seed 7): cameras along x, noisy cameras 1.. and points."""
    K = K_DEMO
    rng = np.random.default_rng(7)
    pts = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-2, 2, n_pts), rng.uniform(6, 12, n_pts)],
                   1).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (n_cams, 1, 1))
    poses[:, 0, 3] = 0.2 * np.arange(n_cams)
    obs = []
    for c in range(n_cams):
        pc = pts @ poses[c, :3, :3].T + poses[c, :3, 3]
        uv = np.stack([K.fx * pc[:, 0] / pc[:, 2] + K.cx, K.fy * pc[:, 1] / pc[:, 2] + K.cy], 1)
        for p in range(n_pts):
            obs.append((c, p, uv[p, 0], uv[p, 1], uv[p, 0] - K.bf / pc[p, 2]))
    obs = np.array(obs, np.float64)
    m = len(obs)
    M = 1 << (m - 1).bit_length()
    O = 16
    obs_cam = np.zeros(M, np.int32)
    obs_cam[:m] = obs[:, 0]
    obs_pt = np.zeros(M, np.int32)
    obs_pt[:m] = obs[:, 1]
    obs_uv = np.zeros((M, 2), np.float32)
    obs_uv[:m] = obs[:, 2:4]
    obs_ur = np.full(M, -1.0, np.float32)
    obs_ur[:m] = obs[:, 4]
    obs_mask = np.zeros(M, bool)
    obs_mask[:m] = True
    pt_slots = np.full((n_pts, O), -1, np.int32)
    fill = np.zeros(n_pts, np.int32)
    cam_counts = np.bincount(obs_cam[:m], minlength=n_cams)
    Oc = 1 << (int(cam_counts.max()) - 1).bit_length()
    cam_slots = np.full((n_cams, Oc), -1, np.int32)
    cfill = np.zeros(n_cams, np.int32)
    for i in range(m):
        p, c = obs_pt[i], obs_cam[i]
        if fill[p] < O:
            pt_slots[p, fill[p]] = i
            fill[p] += 1
        cam_slots[c, cfill[c]] = i
        cfill[c] += 1
    noisy = poses.copy()
    noisy[1:, :3, 3] += rng.normal(0, 0.02, (n_cams - 1, 3)).astype(np.float32)
    return dict(
        cam_pose=noisy, cam_fixed=np.arange(n_cams) == 0, cam_mask=np.ones(n_cams, bool),
        pt_pos=pts + rng.normal(0, 0.02, pts.shape).astype(np.float32), pt_mask=np.ones(n_pts, bool),
        obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=obs_uv, obs_ur=obs_ur, obs_inv_sigma2=np.ones(M, np.float32),
        obs_mask=obs_mask, pt_obs_slots=pt_slots, cam_obs_slots=cam_slots,
    )


def pg_problem(nv: int = 16) -> dict:
    """A ring Sim3 pose graph with drifted vertices (numpy fields of
    PoseGraphProblem), the same on every rank (seed 11)."""
    rng = np.random.default_rng(11)
    ang = 2.0 * np.pi * np.arange(nv) / nv
    gt = np.tile(np.eye(4, dtype=np.float32), (nv, 1, 1))
    gt[:, 0, 3] = 3.0 * np.cos(ang)
    gt[:, 2, 3] = 3.0 * np.sin(ang)
    est = gt.copy()
    est[1:, :3, 3] += rng.normal(0, 0.05, (nv - 1, 3)).astype(np.float32)
    e_i = np.arange(nv, dtype=np.int32)
    e_j = (e_i + 1) % nv
    rel = np.stack([gt[j] @ np.linalg.inv(gt[i]) for i, j in zip(e_i, e_j)]).astype(np.float32)
    return dict(
        v_R=est[:, :3, :3].copy(), v_t=est[:, :3, 3].copy(), v_s=np.ones(nv, np.float32),
        v_fixed=np.arange(nv) == 0, v_mask=np.ones(nv, bool), e_i=e_i, e_j=e_j.astype(np.int32),
        e_R=rel[:, :3, :3].copy(), e_t=rel[:, :3, 3].copy(), e_s=np.ones(nv, np.float32),
        e_mask=np.ones(nv, bool), e_weight=np.ones(nv, np.float32),
    )


def migration_case(n_ranks: int, R: int = 16, F: int = 4):
    """(rows, mask, owner): R slots per rank, 60% live, the capacity covering
    every destination's load."""
    rng = np.random.default_rng(5)
    rows = rng.normal(size=(n_ranks * R, F)).astype(np.float32)
    mask = rng.random(n_ranks * R) < 0.6
    owner = rng.integers(0, n_ranks, n_ranks * R).astype(np.int32)
    assert np.bincount(owner[mask], minlength=n_ranks).max() <= R
    return rows, mask, owner


def redeal(rows: np.ndarray, mask: np.ndarray, owner: np.ndarray, n_ranks: int):
    """The plain re-deal `migrate_points` computes: rank d's block holds the live
    rows bound for d, source-rank-major, up to its R slots."""
    R = rows.shape[0] // n_ranks
    out = np.zeros_like(rows)
    out_mask = np.zeros(len(mask), bool)
    for d in range(n_ranks):
        got = rows[mask & (owner == d)][:R]
        out[d * R: d * R + len(got)] = got
        out_mask[d * R: d * R + len(got)] = True
    return out, out_mask


def problems(device=None):
    """(GlobalBAProblem, PoseGraphProblem) of the demo on `device`."""
    ba = GlobalBAProblem(**{k: torch.from_numpy(v).to(device) for k, v in ba_problem().items()})
    pg = PoseGraphProblem(**{k: torch.from_numpy(v).to(device) for k, v in pg_problem().items()})
    return ba, pg


def run_distributed(mesh) -> dict:
    """Every distributed program of the demo over `mesh`: numpy results, the
    same on every rank of the mesh."""
    from slam_framework_torch.parallel import dist_ba, dist_pose_graph, map_shard

    ba, pg = problems()
    n = mesh.size
    res = dist_ba.optimize_global_sharded(dist_ba.shard_problem(ba, n, device=mesh.shard_device), mesh, K_DEMO,
                                          **BA_ITERS)
    n_live = int(ba.pt_mask.sum())
    owner = (np.arange(n_live) * n) // n_live  # contiguous segment blocks
    res_seg = dist_ba.optimize_global_sharded(
        dist_ba.shard_problem(ba, n, owner=owner, device=mesh.shard_device), mesh, K_DEMO, **BA_ITERS)
    rows, mask, new_owner = migration_case(n)
    mig_rows, mig_mask = map_shard.migrate_points(mesh, rows, mask, new_owner)
    want_rows, want_mask = redeal(rows, mask, new_owner, n)
    pg_res = dist_pose_graph.optimize_sharded(dist_pose_graph.shard_problem(pg, n, device=mesh.shard_device),
                                              mesh, **PG_ITERS)
    host = dist_ba.host
    return {
        "ba_cam": host(res.cam_pose), "ba_pt": dist_ba.unshard_points(host(res.pt_pos), n_live, n),
        "ba_chi2": host(res.total_chi2), "segba_cam": host(res_seg.cam_pose),
        "mig_rows": mig_rows, "mig_mask": mig_mask,
        "migrate_ok": np.array(bool(np.array_equal(mig_mask, want_mask)
                                    and mig_rows.tobytes() == want_rows.tobytes())),
        "pg_R": host(pg_res.v_R), "pg_t": host(pg_res.v_t), "pg_s": host(pg_res.v_s),
        "device": np.array(str(mesh.device)),
    }


def _rank_main(rank: int, world_size: int, init_method: str, device: str, out_dir: str) -> None:
    """One spawned rank (torch.multiprocessing passes `rank` first)."""
    from slam_framework_torch.parallel import multihost

    torch.set_num_threads(1)
    mesh = multihost.initialize(init_method, world_size, rank, device=device)
    try:
        out = run_distributed(mesh)
        if not bool(out["migrate_ok"]):
            raise RuntimeError(f"rank {rank}: the migrated rows differ from the plain re-deal")
        if rank == 0:
            np.savez(os.path.join(out_dir, "ranks.npz"), backend=np.array(str(torch.distributed.get_backend())),
                     **out)
    finally:
        multihost.shutdown()


def spawn(processes: int, device: str, init_method: str, out_dir: str):
    """Start the ranks and return their context (`collect` joins them)."""
    import torch.multiprocessing as mp

    return mp.start_processes(_rank_main, args=(processes, init_method, device, out_dir), nprocs=processes,
                              join=False, start_method="spawn")


def collect(context, out_dir: str, timeout_s: float = 300.0) -> dict:
    """Join the ranks (raising a rank's failure; stopping them all after
    timeout_s) and load rank 0's results."""
    deadline = time.monotonic() + timeout_s
    try:
        while not context.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the ranks did not finish within {timeout_s} s")
    finally:
        for p in context.processes:
            if p.is_alive():
                p.terminate()
            p.join()
    with np.load(os.path.join(out_dir, "ranks.npz")) as z:
        return {k: z[k] for k in z.files}


def single_rank(device) -> dict:
    """The single-rank optimizers on the demo's problems, on `device`."""
    ba, pg = problems(device)
    res = global_ba.optimize_global(ba, K_DEMO, **BA_ITERS)
    pg_res = pose_graph.optimize(pg, **PG_ITERS)
    return {"ba_cam": res.cam_pose.cpu().numpy(), "pg_t": pg_res.v_t.cpu().numpy()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"), help="default: cuda")
    ap.add_argument("--port", type=int, default=0, help="tcp://localhost:PORT rendezvous (default: a file)")
    ap.add_argument("--out", default="", help="directory for rank 0's results (default: a temporary one)")
    args = ap.parse_args()
    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = args.out or tmp
        os.makedirs(out_dir, exist_ok=True)
        init = f"tcp://localhost:{args.port}" if args.port else "file://" + os.path.join(out_dir, "rendezvous")
        if os.path.exists(os.path.join(out_dir, "rendezvous")):
            os.remove(os.path.join(out_dir, "rendezvous"))
        t0 = time.perf_counter()
        context = spawn(args.processes, device.type, init, out_dir)
        ref = single_rank(device)
        got = collect(context, out_dir)
        wall = time.perf_counter() - t0
    errs = {
        "ba_cam_max_err_m": float(np.abs(got["ba_cam"][:, :3, 3] - ref["ba_cam"][:, :3, 3]).max()),
        "segba_cam_max_err_m": float(np.abs(got["segba_cam"][:, :3, 3] - ref["ba_cam"][:, :3, 3]).max()),
        "pg_vt_max_err_m": float(np.abs(got["pg_t"] - ref["pg_t"]).max()),
    }
    print(json.dumps({
        "processes": args.processes, "backend": str(got["backend"]), "rank0_device": str(got["device"]),
        **errs, "migrate_ok": bool(got["migrate_ok"]), "wall_s": wall,
        "ok": bool(got["migrate_ok"]) and max(errs.values()) < TOL_M,
    }), flush=True)


if __name__ == "__main__":
    main()
