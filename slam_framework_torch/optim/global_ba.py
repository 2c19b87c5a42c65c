"""Global bundle adjustment: matrix-free Schur-complement CG over the whole map.

Port of slam_framework_tpu/optim/global_ba.py, after
Optimizer::GlobalBundleAdjustemnt / BundleAdjustment (optimizer.cpp:18-207) and
the loop closer's follow-up global BA (loop_closer.cpp:73-172). The reduced
camera system is never formed:

  - residuals and Jacobian rows are those of the local BA (optim/local_ba.py),
    one batched pass over the observation table;
  - the Schur complement S = Hcc - W Hpp^-1 W^T is applied matrix-free inside a
    block-Jacobi preconditioned conjugate gradient: each product is two gathers
    over the per-point observation slots and one over the per-camera slots, so
    the cost is O(M) per iteration whatever the number of cameras (the local
    BA's explicit (6C, 6C) product is fine at C = 32 and hopeless at 1024);
  - per-camera sums (Hcc blocks, gradients, the second Schur term) gather
    through a fixed-fanout table cam_obs_slots (C, Oc), the camera-side twin of
    pt_obs_slots, and sum along the slot axis: no scatter-add, so two runs
    give the same bits. The reference sums the slot axis in chunks to bound
    its intermediate; here it is one gather and one sum (at C = 128, Oc = 2048
    and 36 columns that is 37 MB), which rounds in another order.

Nothing inside `optimize_global` reads a value back to the host (accept/reject
and the damping are `torch.where`s, the 6x6 blocks are inverted without a
status check), so the call only enqueues work: the loop closer dispatches it
and fetches the result at a later keyframe.

This is also the program the distributed layer shards (parallel/dist_ba.py):
each rank of a mesh runs it on its block of points and observations, and its
`allreduce=` hook sums every camera-space reduction and every cost over the
ranks, where the reference psums over its `axis_name`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from slam_framework_torch.geometry import se3
from slam_framework_torch.geometry.projection import Intrinsics
from slam_framework_torch.optim import reproj
from slam_framework_torch.optim.local_ba import _chi2_scalars, _index_tensors, _inv3x3, _project_scalars
from slam_framework_torch.optim.robust import CHI2_MONO, CHI2_STEREO, huber_weight


class GlobalBAProblem(NamedTuple):
    """Fixed-shape global-BA problem; its observation fields are those of
    `local_ba.BAProblem`, so the residual helpers are shared."""

    cam_pose: torch.Tensor        # (C, 4, 4) Tcw
    cam_fixed: torch.Tensor       # (C,) bool
    cam_mask: torch.Tensor        # (C,) bool
    pt_pos: torch.Tensor          # (P, 3)
    pt_mask: torch.Tensor         # (P,) bool
    obs_cam: torch.Tensor         # (M,) int32
    obs_pt: torch.Tensor          # (M,) int32
    obs_uv: torch.Tensor          # (M, 2)
    obs_ur: torch.Tensor          # (M,)
    obs_inv_sigma2: torch.Tensor  # (M,)
    obs_mask: torch.Tensor        # (M,) bool
    pt_obs_slots: torch.Tensor    # (P, O) int32 — obs ids per point (-1 pad)
    cam_obs_slots: torch.Tensor   # (C, Oc) int32 — obs ids per camera (-1 pad)


class GlobalBAResult(NamedTuple):
    cam_pose: torch.Tensor
    pt_pos: torch.Tensor
    obs_inlier: torch.Tensor
    chi2: torch.Tensor
    total_chi2: torch.Tensor


def _identity(x):
    return x


def _pcg_cam(hvp, b, Minv, iters: int):
    """Block-Jacobi preconditioned CG on the (C, 6) camera system."""

    def prec(r):
        return torch.einsum("cij,cj->ci", Minv, r)

    x = torch.zeros_like(b)
    r = b
    z = prec(r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(iters):
        Ap = hvp(p)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.clamp(rz, min=1e-20)
        p = z + beta * p
        rz = rz_new
    return x


def optimize_global(
    prob: GlobalBAProblem,
    K: Intrinsics,
    iters_first: int = 5,
    iters_second: int = 10,
    cg_iters: int = 60,
    lam0: float = 1e-4,
    allreduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> GlobalBAResult:
    """allreduce: None for the whole problem on one device. Set, the problem's
    point and observation tensors are one rank's shard (parallel/dist_ba.py)
    and every camera-space sum and every cost is passed through it (the sum
    over the ranks, `RankMesh.all_reduce_sum`) where the reference psums over
    its `axis_name`: the camera state stays replicated, bit-equal on every
    rank."""
    red = allreduce if allreduce is not None else _identity
    C = prob.cam_pose.shape[0]
    dev, f32 = prob.cam_pose.device, torch.float32
    is_stereo = prob.obs_ur >= 0.0
    stereo_f = is_stereo.to(f32)
    delta2 = torch.where(is_stereo, torch.full_like(prob.obs_ur, CHI2_STEREO),
                         torch.full_like(prob.obs_ur, CHI2_MONO))
    free = (~prob.cam_fixed) & prob.cam_mask
    free_f = free.to(f32)[:, None]

    obs_cam = prob.obs_cam.long()
    obs_pt = prob.obs_pt.long()
    slots_p = prob.pt_obs_slots.long()
    has_p = (slots_p >= 0).to(f32)[..., None]
    safe_p = torch.clamp(slots_p, min=0)
    slots_c = prob.cam_obs_slots.long()
    has_c = (slots_c >= 0).to(f32)[..., None]
    safe_c = torch.clamp(slots_c, min=0)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    eye6 = torch.eye(6, dtype=f32, device=dev)
    I6, J6, IDX6, I3, J3, IDX3 = _index_tensors(dev)
    pt_mask_f = prob.pt_mask.to(f32)[:, None]
    zero = torch.zeros((), dtype=f32, device=dev)

    def per_point(data):  # (M, D) -> (P, D)
        return torch.sum(data[safe_p] * has_p, dim=1)

    def per_camera(data):  # (M, D) -> (C, D)
        return torch.sum(data[safe_c] * has_c, dim=1)

    def project(cam_pose, pt_pos):
        return _project_scalars(cam_pose, pt_pos, prob, K, obs_cam, obs_pt)

    def chi2_of(cam_pose, pt_pos):
        _, _, z, ru, rv, rur, _ = project(cam_pose, pt_pos)
        return _chi2_scalars(ru, rv, rur, z, prob, is_stereo)

    def clipped_sum(chi2, ok):
        return torch.sum(torch.where(ok, torch.clamp(chi2, max=1e6), zero))

    def lm_iters(cam_pose, pt_pos, active, n_iters):
        active_f = active.to(f32)
        lam = torch.full((), lam0, dtype=f32, device=dev)
        for _ in range(n_iters):
            x, y, z, r_u, r_v, r_ur, R_cols = project(cam_pose, pt_pos)
            chi2 = _chi2_scalars(r_u, r_v, r_ur, z, prob, is_stereo)
            w = huber_weight(chi2, delta2) * prob.obs_inv_sigma2
            # behind-camera / grazing observations get no weight (see optim/local_ba.py)
            w_uv = (w * active_f * (z > 1e-2).to(f32))[:, None]
            w_ur = w_uv * stereo_f[:, None]

            du, dv, dur, _ = reproj.camera_rows(x, y, z, K)
            pu, pv, pur = reproj.point_rows(x, y, z, R_cols, K)
            Du, Dv, Dur = torch.stack(du, -1), torch.stack(dv, -1), torch.stack(dur, -1)  # (M, 6)
            Pu, Pv, Pur = torch.stack(pu, -1), torch.stack(pv, -1), torch.stack(pur, -1)  # (M, 3)
            ru, rv, rur = r_u[:, None], r_v[:, None], r_ur[:, None]

            # Hcc (21 unique) + bc (6), summed per camera
            per_cam = red(per_camera(torch.cat([
                w_uv * (Du[:, I6] * Du[:, J6] + Dv[:, I6] * Dv[:, J6]) + w_ur * Dur[:, I6] * Dur[:, J6],
                w_uv * (Du * ru + Dv * rv) + w_ur * Dur * rur,
            ], dim=1)))
            Hcc = per_cam[:, IDX6]  # (C, 6, 6)
            bc = per_cam[:, 21:27]

            # Hpp (6 unique) + bp (3), summed per point
            per_pt = per_point(torch.cat([
                w_uv * (Pu[:, I3] * Pu[:, J3] + Pv[:, I3] * Pv[:, J3]) + w_ur * Pur[:, I3] * Pur[:, J3],
                w_uv * (Pu * ru + Pv * rv) + w_ur * Pur * rur,
            ], dim=1))
            Hpp = per_pt[:, IDX3]   # (P, 3, 3)
            bp = per_pt[:, 6:9]

            # coupling W (M, 6, 3)
            W = (
                w_uv[:, :, None] * (Du[:, :, None] * Pu[:, None, :] + Dv[:, :, None] * Pv[:, None, :])
                + w_ur[:, :, None] * Dur[:, :, None] * Pur[:, None, :]
            )

            Hpp_inv = _inv3x3(Hpp + (lam + 1e-8) * eye3)
            Hcc_d = Hcc + lam * Hcc * eye6 + 1e-8 * eye6
            Hpi_of_obs = Hpp_inv[obs_pt]  # (M, 3, 3)

            def schur_mv(v):
                v = v * free_f
                a_p = per_point(torch.einsum("mij,mi->mj", W, v[obs_cam]))          # (P, 3)
                b_p = torch.einsum("pij,pj->pi", Hpp_inv, a_p)
                sub = red(per_camera(torch.einsum("mij,mj->mi", W, b_p[obs_pt])))   # (C, 6)
                out = torch.einsum("cij,cj->ci", Hcc_d, v) - sub
                return out * free_f + (1.0 - free_f) * v

            # rhs = bc - W Hpp^-1 bp
            q_rhs = torch.einsum("mij,mj->mi", W, torch.einsum("mij,mj->mi", Hpi_of_obs, bp[obs_pt]))
            rhs = (bc - red(per_camera(q_rhs))) * free_f

            # block-Jacobi preconditioner: diag(S) ~ Hcc_d - sum_obs W Hpp^-1 W^T
            diag_sub = torch.einsum("mij,mjk,mlk->mil", W, Hpi_of_obs, W).reshape(-1, 36)
            S_diag = Hcc_d - red(per_camera(diag_sub)).reshape(C, 6, 6)
            Minv = torch.linalg.inv_ex(S_diag + 1e-5 * eye6)[0]

            dxc = -_pcg_cam(schur_mv, rhs, Minv, cg_iters) * free_f
            # back-substitute the points
            sum_Wt = per_point(torch.einsum("mij,mi->mj", W, dxc[obs_cam]))
            dxp = -torch.einsum("pij,pj->pi", Hpp_inv, bp + sum_Wt) * pt_mask_f

            new_cam = se3.compose(se3.se3_exp(dxc), cam_pose)
            new_cam = torch.where(free[:, None, None], new_cam, cam_pose)
            new_pt = pt_pos + dxp

            _, _, z2, ru2, rv2, rur2, _ = project(new_cam, new_pt)
            chi2_new = _chi2_scalars(ru2, rv2, rur2, z2, prob, is_stereo)
            # acceptance compares only observations in front on BOTH sides
            cmp_ok = active & (z > 1e-2) & (z2 > 1e-2)
            improved = red(clipped_sum(chi2_new, cmp_ok)) < red(clipped_sum(chi2, cmp_ok))
            cam_pose = torch.where(improved, new_cam, cam_pose)
            pt_pos = torch.where(improved, new_pt, pt_pos)
            lam = torch.clamp(torch.where(improved, lam * 0.5, lam * 5.0), 1e-8, 1e5)
        return cam_pose, pt_pos

    active0 = prob.obs_mask
    cam_pose, pt_pos = lm_iters(prob.cam_pose, prob.pt_pos, active0, iters_first)
    active1 = active0 & (chi2_of(cam_pose, pt_pos) <= delta2)
    cam_pose, pt_pos = lm_iters(cam_pose, pt_pos, active1, iters_second)
    chi2 = chi2_of(cam_pose, pt_pos)
    inlier = prob.obs_mask & (chi2 <= delta2)
    total = red(torch.sum(torch.where(inlier, chi2, zero)))
    return GlobalBAResult(
        cam_pose=se3.reorthonormalize(cam_pose), pt_pos=pt_pos,
        obs_inlier=inlier, chi2=chi2, total_chi2=total,
    )


# ---------------------------------------------------------------------- arena glue

def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def build_global_problem(
    arena,
    cfg,
    fix_kfs: Optional[list] = None,
    max_obs_per_point: int = 16,
    device=None,
) -> Tuple[GlobalBAProblem, np.ndarray, np.ndarray]:
    """Assemble the full-map BA problem from the arena on `device`
    (optimizer.cpp:18-45 builds the same from the pointer graph). Returns
    (problem, cam_ids, point_ids). Every extent is padded to a power of two."""
    n_kfs = arena.num_kfs
    cams = np.nonzero(arena.kf_valid[:n_kfs])[0]
    pids = np.nonzero(arena.pt_valid[: arena.num_pts])[0]
    C = _next_pow2(max(len(cams), 2))
    P = _next_pow2(max(len(pids), 2))
    O = max_obs_per_point
    inv_sf2 = 1.0 / (cfg.orb.scale_factor ** (2.0 * np.arange(cfg.orb.num_levels)))

    kf_to_cam = np.full(n_kfs, -1, np.int32)
    kf_to_cam[cams] = np.arange(len(cams), dtype=np.int32)

    obs_kf_tab = arena.pt_obs_kf[pids][:, :O]
    obs_ft_tab = arena.pt_obs_feat[pids][:, :O]
    valid_tab = obs_kf_tab >= 0
    cam_tab = np.where(valid_tab, kf_to_cam[np.maximum(obs_kf_tab, 0)], -1)
    valid_tab &= cam_tab >= 0

    flat_sel = np.nonzero(valid_tab.reshape(-1))[0]
    m = len(flat_sel)
    M = _next_pow2(max(m, 2))
    pi_flat = (flat_sel // O).astype(np.int32)
    kf_flat = obs_kf_tab.reshape(-1)[flat_sel]
    ft_flat = obs_ft_tab.reshape(-1)[flat_sel]

    obs_cam = np.zeros(M, np.int32)
    obs_pt = np.zeros(M, np.int32)
    obs_uv = np.zeros((M, 2), np.float32)
    obs_ur = np.full(M, -1.0, np.float32)
    obs_w = np.ones(M, np.float32)
    obs_mask = np.zeros(M, bool)
    obs_cam[:m] = cam_tab.reshape(-1)[flat_sel]
    obs_pt[:m] = pi_flat
    obs_uv[:m] = arena.kf_xy[kf_flat, ft_flat]
    obs_ur[:m] = arena.kf_ur[kf_flat, ft_flat]
    obs_w[:m] = inv_sf2[np.clip(arena.kf_octave[kf_flat, ft_flat], 0, cfg.orb.num_levels - 1)]
    obs_mask[:m] = True

    rank = (np.cumsum(valid_tab, axis=1) - 1).reshape(-1)[flat_sel]
    pt_slots = np.full((P, O), -1, np.int32)
    pt_slots[pi_flat, rank] = np.arange(m, dtype=np.int32)

    # camera-side slots
    order = np.argsort(obs_cam[:m], kind="stable")
    sorted_cam = obs_cam[:m][order]
    counts = np.bincount(sorted_cam, minlength=C)
    Oc = _next_pow2(max(int(counts.max()) if m else 1, 1))
    cam_slots = np.full((C, Oc), -1, np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for c in range(len(cams)):
        s, e = starts[c], starts[c + 1]
        cam_slots[c, : e - s] = order[s:e]

    cam_pose = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    cam_pose[: len(cams)] = arena.kf_pose[cams]
    cam_mask = np.zeros(C, bool)
    cam_mask[: len(cams)] = True
    cam_fixed = np.ones(C, bool)
    fix_set = set(int(f) for f in (fix_kfs if fix_kfs is not None else [int(cams[0])]))
    for i, c in enumerate(cams):
        cam_fixed[i] = int(c) in fix_set

    pt_pos = np.zeros((P, 3), np.float32)
    pt_pos[: len(pids)] = arena.pt_pos[pids]
    pt_mask = np.zeros(P, bool)
    pt_mask[: len(pids)] = True

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    prob = GlobalBAProblem(
        cam_pose=put(cam_pose),
        cam_fixed=put(cam_fixed),
        cam_mask=put(cam_mask),
        pt_pos=put(pt_pos),
        pt_mask=put(pt_mask),
        obs_cam=put(obs_cam),
        obs_pt=put(obs_pt),
        obs_uv=put(obs_uv),
        obs_ur=put(obs_ur),
        obs_inv_sigma2=put(obs_w),
        obs_mask=put(obs_mask),
        pt_obs_slots=put(pt_slots),
        cam_obs_slots=put(cam_slots),
    )
    return prob, cams, pids


def run_global_ba(arena, cfg, K: Intrinsics, iters: Tuple[int, int] = (5, 10), device=None) -> dict:
    """Full-map BA + write-back (GlobalBundleAdjustemnt, optimizer.cpp:18-31; the
    loop-closer variant fixes keyframe 0 and runs 10 iterations)."""
    prob, cams, pids = build_global_problem(arena, cfg, device=device)
    res = optimize_global(prob, K=K, iters_first=iters[0], iters_second=iters[1])
    new_cam, new_pt = res.cam_pose.cpu().numpy(), res.pt_pos.cpu().numpy()
    fixed = prob.cam_fixed.cpu().numpy()
    for i, c in enumerate(cams):
        if not fixed[i]:
            arena.kf_pose[c] = new_cam[i]
    arena.pt_pos[pids] = new_pt[: len(pids)]
    return {
        "cams": len(cams),
        "points": len(pids),
        "obs": int(prob.obs_mask.sum()),
        "chi2": float(res.total_chi2),
    }
