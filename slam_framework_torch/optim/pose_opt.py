"""Motion-only bundle adjustment (pose optimization) — the per-frame solver.

Port of slam_framework_tpu/optim/pose_opt.py: one SE3 pose against fixed map
points with Huber-robustified mono/stereo reprojection edges; n_rounds x
n_iters LM iterations with chi2 reclassification after each round (5.991 mono,
7.815 stereo); information = inv_sigma2 per observation octave.

The reference's `lax.scan`s are Python loops here. Its unrolled 6x6 Cholesky
(utils/linalg.py) becomes `torch.linalg.cholesky_ex` + `cholesky_solve`, which
never synchronises with the host; a system that is not positive definite
gives a zero step, which the LM test then rejects like the reference's
huge clamped-pivot step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_framework_torch.geometry import se3
from slam_framework_torch.geometry.projection import Intrinsics
from slam_framework_torch.optim import reproj
from slam_framework_torch.optim.robust import CHI2_MONO, CHI2_STEREO, huber_weight

N_ROUNDS = 4
N_ITERS = 10


class PoseObs(NamedTuple):
    """Fixed-capacity observation block for one frame."""

    points_w: torch.Tensor    # (N, 3) world points
    uv: torch.Tensor          # (N, 2) measured pixel (undistorted)
    ur: torch.Tensor          # (N,)  measured right-image u; < 0 => mono observation
    inv_sigma2: torch.Tensor  # (N,)  information scale (1/1.2^(2*octave))
    mask: torch.Tensor        # (N,)  bool — slot holds a real observation


class PoseOptResult(NamedTuple):
    pose: torch.Tensor         # (4, 4) optimized Tcw
    inliers: torch.Tensor      # (N,) bool — post-optimization inlier classification
    num_inliers: torch.Tensor  # () int32


def _residuals(Tcw: torch.Tensor, obs: PoseObs, K: Intrinsics):
    """Residuals (N, 3) as [u, v, ur] (meas - pred) and camera-frame depth z."""
    Xc = se3.transform_points(Tcw, obs.points_w)
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    inv_z = 1.0 / torch.where(z > 1e-6, z, torch.full_like(z, 1e-6))
    u = K.fx * x * inv_z + K.cx
    v = K.fy * y * inv_z + K.cy
    r = torch.stack([obs.uv[:, 0] - u, obs.uv[:, 1] - v, obs.ur - (u - K.bf * inv_z)], dim=-1)
    return r, x, y, z


def _solve_spd(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    L, info = torch.linalg.cholesky_ex(H)
    x = torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.where(info == 0, x, torch.zeros_like(x))


def optimize_pose(
    Tcw0: torch.Tensor,
    obs: PoseObs,
    K: Intrinsics,
    n_rounds: int = N_ROUNDS,
    n_iters: int = N_ITERS,
) -> PoseOptResult:
    """Run the n_rounds x n_iters LM schedule with per-round chi2 reclassification."""
    is_stereo = obs.ur >= 0.0
    delta2 = torch.where(is_stereo, torch.full_like(obs.ur, CHI2_STEREO), torch.full_like(obs.ur, CHI2_MONO))
    zero = torch.zeros_like(obs.ur)
    eye6 = torch.eye(6, dtype=Tcw0.dtype, device=Tcw0.device)

    def chi2_of(r, z):
        r2 = r[:, 0] ** 2 + r[:, 1] ** 2 + torch.where(is_stereo, r[:, 2] ** 2, zero)
        # behind-camera observations are outliers regardless of pixel error
        return torch.where(z > 1e-6, r2 * obs.inv_sigma2, torch.full_like(z, 1e9))

    def total(chi2, active):
        return torch.where(active, torch.clamp(chi2, max=1e6), zero).sum()

    Tcw = Tcw0
    active = obs.mask
    for _ in range(n_rounds):
        lam = torch.full((), 1e-3, dtype=Tcw0.dtype, device=Tcw0.device)
        for _ in range(n_iters):
            r, x, y, z = _residuals(Tcw, obs, K)
            chi2 = chi2_of(r, z)
            w_rob = huber_weight(chi2, delta2) * obs.inv_sigma2
            du, dv, dur, _ = reproj.camera_rows(x, y, z, K)
            # behind-camera / grazing points get zero weight: their clamped
            # inv_z makes residuals and Jacobian rows astronomical
            in_front = (z > 1e-2).to(torch.float32)
            w_uv = w_rob * active.to(torch.float32) * in_front
            w_ur = w_uv * is_stereo.to(torch.float32)
            H = reproj.sym_outer_sum([(du, w_uv), (dv, w_uv), (dur, w_ur)], 6)
            b = reproj.rhs_sum([(du, w_uv, r[:, 0]), (dv, w_uv, r[:, 1]), (dur, w_ur, r[:, 2])], 6)
            # LM step with multiplicative damping on the diagonal
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye6
            dx = -_solve_spd(Hd, b)
            Tcw_new = se3.compose(se3.se3_exp(dx), Tcw)
            r_new, _, _, z_new = _residuals(Tcw_new, obs, K)
            improved = total(chi2_of(r_new, z_new), active) < total(chi2, active)
            Tcw = torch.where(improved, Tcw_new, Tcw)
            lam = torch.clamp(torch.where(improved, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        r, _, _, z = _residuals(Tcw, obs, K)
        active = obs.mask & (chi2_of(r, z) <= delta2)
    # the f32 retraction chain drifts R off SO(3); downstream assumes a rotation
    return PoseOptResult(pose=se3.reorthonormalize(Tcw), inliers=active,
                         num_inliers=active.sum(dtype=torch.int32))
