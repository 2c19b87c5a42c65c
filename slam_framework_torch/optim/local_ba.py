"""Local bundle adjustment with an explicit Schur-complement reduction.

Port of slam_framework_tpu/optim/local_ba.py (Optimizer::LocalBundleAdjustment,
optimizer.cpp:413-716): the whole solver is explicit, batched, fixed-shape
tensor code.

  - Observations are a COO table (cam_idx, pt_idx, uv, ur, inv_sigma2, mask)
    padded to a static M; each point lists its observation slots (P, O).
  - Per LM iteration: scalar residuals/Jacobian rows, Hcc (C,6,6) and bc from
    the 27 unique products summed per camera, Hpp (P,3,3) and bp from 9 summed
    per point, the coupling W (M,6,3), the Schur complement
        S = Hcc - sum_p W_p Hpp_p^-1 W_p^T
    as one (6C, 3P) x (3P, 6C) product, a Jacobi-preconditioned conjugate
    gradient of 28 fixed iterations for the camera step, back-substitution for
    the points, Levenberg damping with accept/reject, Huber weights.
  - Schedule: 5 iterations, drop chi2 outliers, 10 more (optimizer.cpp:607-668),
    thresholds 5.991 mono / 7.815 stereo.

Every reduction is a matrix product against a one-hot matrix or a gather by
slot followed by a sum, never a scatter-add: on a GPU a scatter-add is made of
atomics whose order changes from run to run, and two runs of the same problem
must give the same bits. The conjugate gradient is kept (not a factorisation):
28 iterations do not reach the exact solution, so another solver would take
other LM steps than the reference. Nothing inside `optimize` reads a value back
to the host; accept/reject and the damping update are `torch.where`s, so the
whole function is a fixed sequence of launches.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from slam_framework_torch.geometry import se3
from slam_framework_torch.geometry.projection import Intrinsics
from slam_framework_torch.optim import reproj
from slam_framework_torch.optim.robust import CHI2_MONO, CHI2_STEREO, huber_weight

PCG_ITERS = 28


class BAProblem(NamedTuple):
    """Fixed-shape local-BA problem. C cams, P points, M observation slots."""

    cam_pose: torch.Tensor        # (C, 4, 4) Tcw
    cam_fixed: torch.Tensor       # (C,) bool — pose held constant
    cam_mask: torch.Tensor        # (C,) bool — slot in use
    pt_pos: torch.Tensor          # (P, 3)
    pt_mask: torch.Tensor         # (P,) bool
    obs_cam: torch.Tensor         # (M,) int32
    obs_pt: torch.Tensor          # (M,) int32
    obs_uv: torch.Tensor          # (M, 2)
    obs_ur: torch.Tensor          # (M,) — < 0 for mono observations
    obs_inv_sigma2: torch.Tensor  # (M,)
    obs_mask: torch.Tensor        # (M,) bool
    pt_obs_slots: torch.Tensor    # (P, O) int32 — obs indices per point (-1 pad)


class BAResult(NamedTuple):
    cam_pose: torch.Tensor
    pt_pos: torch.Tensor
    obs_inlier: torch.Tensor  # (M,) bool — survived chi2 classification
    chi2: torch.Tensor        # (M,) final per-obs chi2
    total_chi2: torch.Tensor  # () f32


def _sym_tables(n: int):
    """Upper-triangle pair lists (I, J) in row-major order and the (n, n) table
    that reads a symmetric matrix back out of those n(n+1)/2 columns."""
    I, J, table = [], [], [[0] * n for _ in range(n)]
    for i in range(n):
        for j in range(i, n):
            table[i][j] = table[j][i] = len(I)
            I.append(i)
            J.append(j)
    return I, J, table


@functools.lru_cache(maxsize=None)
def _index_tensors(device: torch.device):
    """(I6, J6, IDX6, I3, J3, IDX3) on the device, uploaded once: a fresh
    host-to-device copy per call could not be captured in a CUDA graph."""
    out = []
    for n in (6, 3):
        out += [torch.tensor(t, device=device) for t in _sym_tables(n)]
    return tuple(out)


def _project_scalars(cam_pose, pt_pos, prob: BAProblem, K: Intrinsics, obs_cam, obs_pt):
    """Per-observation (M,) camera-frame coordinates, residuals and the observing
    camera's rotation entries. obs_cam / obs_pt: the problem's indices as int64."""
    cp = cam_pose.reshape(cam_pose.shape[0], 16)[obs_cam]  # (M, 16)
    R00, R01, R02, t0, R10, R11, R12, t1, R20, R21, R22, t2 = cp[:, :12].unbind(dim=1)
    X0, X1, X2 = pt_pos[obs_pt].unbind(dim=1)
    x = R00 * X0 + R01 * X1 + R02 * X2 + t0
    y = R10 * X0 + R11 * X1 + R12 * X2 + t1
    z = R20 * X0 + R21 * X1 + R22 * X2 + t2
    inv_z = 1.0 / torch.where(z > 1e-6, z, torch.full_like(z, 1e-6))
    u = K.fx * x * inv_z + K.cx
    v = K.fy * y * inv_z + K.cy
    r_u = prob.obs_uv[:, 0] - u
    r_v = prob.obs_uv[:, 1] - v
    r_ur = prob.obs_ur - (u - K.bf * inv_z)
    Rc = (R00, R01, R02, R10, R11, R12, R20, R21, R22)
    return x, y, z, r_u, r_v, r_ur, Rc


def _chi2_scalars(r_u, r_v, r_ur, z, prob: BAProblem, is_stereo):
    r2 = r_u**2 + r_v**2 + torch.where(is_stereo, r_ur**2, torch.zeros_like(r_ur))
    c = r2 * prob.obs_inv_sigma2
    return torch.where(z > 1e-6, c, torch.full_like(c, 1e9))


def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / determinant), elementwise."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    adj = torch.stack(
        [
            torch.stack([A11, A12, A13], -1),
            torch.stack([A21, A22, A23], -1),
            torch.stack([A31, A32, A33], -1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def _pcg(A: torch.Tensor, b: torch.Tensor, iters: int = 50) -> torch.Tensor:
    """Jacobi-preconditioned conjugate gradient for SPD A x = b, a fixed number
    of iterations. The matvec is full fp32: the Schur system's diagonal spans
    about 1e6 and a reduced-precision product stalls the convergence."""
    d_inv = 1.0 / torch.clamp(torch.abs(torch.diagonal(A)), min=1e-12)
    x = torch.zeros_like(b)
    r = b
    z = d_inv * r
    p = z
    rz = torch.dot(r, z)
    for _ in range(iters):
        Ap = torch.mv(A, p)
        alpha = rz / torch.clamp(torch.dot(p, Ap), min=1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        z = d_inv * r
        rz_new = torch.dot(r, z)
        beta = rz_new / torch.clamp(rz, min=1e-20)
        p = z + beta * p
        rz = rz_new
    return x


def optimize(
    prob: BAProblem,
    K: Intrinsics,
    iters_first: int = 5,
    iters_second: int = 10,
    lam0: float = 1e-4,
) -> BAResult:
    C = prob.cam_pose.shape[0]
    P = prob.pt_pos.shape[0]
    dev = prob.cam_pose.device
    f32 = torch.float32
    is_stereo = prob.obs_ur >= 0.0
    stereo_f = is_stereo.to(f32)
    delta2 = torch.where(is_stereo, torch.full_like(prob.obs_ur, CHI2_STEREO),
                         torch.full_like(prob.obs_ur, CHI2_MONO))
    free = (~prob.cam_fixed) & prob.cam_mask

    # constants of the problem, built once for all 15 iterations
    obs_cam = prob.obs_cam.long()
    obs_pt = prob.obs_pt.long()
    slots = prob.pt_obs_slots.long()          # (P, O)
    has = slots >= 0
    has_f = has.to(f32)
    safe = torch.clamp(slots, min=0)
    cam_of = obs_cam[safe]                    # (P, O)
    cams = torch.arange(C, device=dev)
    onehot_cam_T = (obs_cam[None, :] == cams[:, None]).to(f32)                     # (C, M)
    A_T = ((cam_of[:, None, :] == cams[None, :, None]) & has[:, None, :]).to(f32)  # (P, C, O)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    eye6 = torch.eye(6, dtype=f32, device=dev)
    I6, J6, IDX6, I3, J3, IDX3 = _index_tensors(dev)
    mask6 = free.to(f32).repeat_interleave(6)
    mask66 = mask6[:, None] * mask6[None, :]
    fixed_diag = torch.diag(1.0 - mask6)
    pt_mask_f = prob.pt_mask.to(f32)[:, None]
    zero = torch.zeros((), dtype=f32, device=dev)

    def project(cam_pose, pt_pos):
        return _project_scalars(cam_pose, pt_pos, prob, K, obs_cam, obs_pt)

    def clipped_sum(chi2, ok):
        return torch.sum(torch.where(ok, torch.clamp(chi2, max=1e6), zero))

    def lm_iters(cam_pose, pt_pos, active, n_iters):
        active_f = active.to(f32)
        lam = torch.full((), lam0, dtype=f32, device=dev)
        for _ in range(n_iters):
            x, y, z, r_u, r_v, r_ur, R_cols = project(cam_pose, pt_pos)
            chi2 = _chi2_scalars(r_u, r_v, r_ur, z, prob, is_stereo)
            w = huber_weight(chi2, delta2) * prob.obs_inv_sigma2
            # behind-camera / grazing observations: the clamped 1/z makes
            # residuals and Jacobian rows astronomical, so they get no weight
            w_uv = (w * active_f * (z > 1e-2).to(f32))[:, None]
            w_ur = w_uv * stereo_f[:, None]

            du, dv, dur, _ = reproj.camera_rows(x, y, z, K)
            pu, pv, pur = reproj.point_rows(x, y, z, R_cols, K)
            Du, Dv, Dur = torch.stack(du, -1), torch.stack(dv, -1), torch.stack(dur, -1)  # (M, 6)
            Pu, Pv, Pur = torch.stack(pu, -1), torch.stack(pv, -1), torch.stack(pur, -1)  # (M, 3)
            ru, rv, rur = r_u[:, None], r_v[:, None], r_ur[:, None]

            # Hcc (21 unique) + bc (6): one (M, 27) matrix against the camera one-hot
            stacked = torch.cat([
                w_uv * (Du[:, I6] * Du[:, J6] + Dv[:, I6] * Dv[:, J6]) + w_ur * Dur[:, I6] * Dur[:, J6],
                w_uv * (Du * ru + Dv * rv) + w_ur * Dur * rur,
            ], dim=1)
            per_cam = torch.matmul(onehot_cam_T, stacked)  # (C, 27)
            Hcc = per_cam[:, IDX6]                         # (C, 6, 6), symmetric
            bc = per_cam[:, 21:27]

            # Hpp (6 unique) + bp (3): (M, 9) terms gathered into per-point slots
            pstacked = torch.cat([
                w_uv * (Pu[:, I3] * Pu[:, J3] + Pv[:, I3] * Pv[:, J3]) + w_ur * Pur[:, I3] * Pur[:, J3],
                w_uv * (Pu * ru + Pv * rv) + w_ur * Pur * rur,
            ], dim=1)
            per_pt = torch.sum(pstacked[safe] * has_f[..., None], dim=1)  # (P, 9)
            Hpp = per_pt[:, IDX3]                                         # (P, 3, 3)
            bp = per_pt[:, 6:9]

            # W (M, 6, 3) coupling from 18 scalar products
            W = (
                w_uv[:, :, None] * (Du[:, :, None] * Pu[:, None, :] + Dv[:, :, None] * Pv[:, None, :])
                + w_ur[:, :, None] * Dur[:, :, None] * Pur[:, None, :]
            )

            Hpp_inv = _inv3x3(Hpp + lam * eye3 + 1e-8 * eye3)

            # Schur: S = Hcc_aug - sum_p sum_{a,b in obs(p)} W_a Hpp_p^-1 W_b^T, with
            # U_p = sum_o onehot(cam) W_o Hpp_p^-1 and V_p likewise with W alone.
            Wp = W[safe] * has_f[..., None, None]                                # (P, O, 6, 3)
            O = Wp.shape[1]
            Yp = torch.bmm(Wp.reshape(P, O * 6, 3), Hpp_inv).reshape(P, O, 18)
            UV = torch.bmm(A_T, torch.cat([Yp, Wp.reshape(P, O, 18)], dim=2))    # (P, C, 36)
            # rows (cam, twist component), columns (point, coordinate)
            U2 = UV[:, :, :18].reshape(P, C, 6, 3).permute(1, 2, 0, 3).reshape(6 * C, 3 * P)
            V2 = UV[:, :, 18:].reshape(P, C, 6, 3).permute(1, 2, 0, 3).reshape(6 * C, 3 * P)
            S_big = -torch.matmul(U2, V2.T)                                      # (6C, 6C)
            v = torch.mv(U2, bp.reshape(-1))                                     # (6C,)

            Hcc_d = Hcc + lam * (Hcc * eye6) + 1e-8 * eye6
            # the (C, 6, 6) blocks go onto the block diagonal of the (c, i, d, j) view
            S_blocks = S_big.view(C, 6, C, 6).permute(0, 2, 1, 3)
            S_blocks[cams, cams] += Hcc_d
            rhs = bc.reshape(-1) - v

            # project out fixed / unused cameras: identity rows and columns, zero rhs
            S_big = S_big * mask66 + fixed_diag
            dxc = -_pcg(S_big, rhs * mask6, iters=PCG_ITERS).reshape(C, 6)
            # back-substitute points: dp = -Hpp^-1 (bp + sum_obs W^T dxc[cam])
            sum_Wt = torch.sum(Wp * dxc[cam_of][..., None], dim=(1, 2))          # (P, 3)
            dxp = -torch.bmm(Hpp_inv, (bp + sum_Wt)[..., None])[..., 0]
            dxp = dxp * pt_mask_f

            new_cam = se3.compose(se3.se3_exp(dxc), cam_pose)
            new_cam = torch.where(free[:, None, None], new_cam, cam_pose)
            new_pt = pt_pos + dxp

            _, _, z_new, ru_n, rv_n, rur_n, _ = project(new_cam, new_pt)
            chi2_new = _chi2_scalars(ru_n, rv_n, rur_n, z_new, prob, is_stereo)
            # acceptance compares only observations in front on BOTH sides: an
            # observation flipping across z = 0 would inject +-1e6 jumps
            cmp_ok = active & (z > 1e-2) & (z_new > 1e-2)
            improved = clipped_sum(chi2_new, cmp_ok) < clipped_sum(chi2, cmp_ok)
            cam_pose = torch.where(improved, new_cam, cam_pose)
            pt_pos = torch.where(improved, new_pt, pt_pos)
            lam = torch.clamp(torch.where(improved, lam * 0.5, lam * 5.0), 1e-8, 1e5)
        return cam_pose, pt_pos

    def chi2_of(cam_pose, pt_pos):
        _, _, z, ru, rv, rur, _ = project(cam_pose, pt_pos)
        return _chi2_scalars(ru, rv, rur, z, prob, is_stereo)

    active0 = prob.obs_mask
    cam_pose, pt_pos = lm_iters(prob.cam_pose, prob.pt_pos, active0, iters_first)
    # outlier classification (optimizer.cpp:620-640)
    active1 = active0 & (chi2_of(cam_pose, pt_pos) <= delta2)
    cam_pose, pt_pos = lm_iters(cam_pose, pt_pos, active1, iters_second)
    chi2 = chi2_of(cam_pose, pt_pos)
    inlier = prob.obs_mask & (chi2 <= delta2)
    total = torch.sum(torch.where(inlier, chi2, zero))
    # the f32 retraction chain drifts R off SO(3)
    return BAResult(
        cam_pose=se3.reorthonormalize(cam_pose), pt_pos=pt_pos,
        obs_inlier=inlier, chi2=chi2, total_chi2=total,
    )
