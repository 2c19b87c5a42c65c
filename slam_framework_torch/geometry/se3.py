"""SO3/SE3 Lie-group operations on torch tensors (fp32, batchable).

Port of slam_framework_tpu/geometry/se3.py. Conventions are the reference's:
poses are 4x4 T = [[R, t], [0, 1]], twists are xi = (omega, upsilon), the SE3
exponential uses the V matrix, and optimizer retraction is T <- exp(xi) @ T.
Every matrix product runs in full fp32 (TF32 is pinned off in the package).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so3 hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_coeffs(theta2: torch.Tensor):
    """Numerically safe A = sin(t)/t, B = (1-cos t)/t^2, C = (1 - A)/t^2."""
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < 1e-8
    t2 = torch.clamp(theta2, min=_EPS * _EPS)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / t2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / t2)
    return A, B, C


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """SO3 exponential map: (..., 3) axis-angle -> (..., 3, 3) rotation (Rodrigues)."""
    theta2 = torch.sum(w * w, dim=-1)
    A, B, _ = _sinc_coeffs(theta2)
    W = hat(w)
    return _eye3(W) + A[..., None, None] * W + B[..., None, None] * torch.matmul(W, W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """SO3 logarithm: (..., 3, 3) -> (..., 3) axis-angle. Safe near 0 and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w_skew = vee(R - R.transpose(-1, -2)) * 0.5  # = axis * sin(theta)
    sin2 = torch.sum(w_skew * w_skew, dim=-1)
    near_one = cos_theta > 1.0 - 1e-6
    near_pi = cos_theta < -1.0 + 1e-5
    mid = ~(near_one | near_pi)
    one = torch.ones_like(sin2)
    sin_theta = torch.sqrt(torch.where(mid, torch.clamp(sin2, min=1e-12), one))
    theta_mid = torch.atan2(sin_theta, torch.where(mid, cos_theta, torch.zeros_like(cos_theta)))
    scale = torch.where(near_one, 1.0 + sin2 / 6.0, theta_mid / sin_theta)
    w_generic = w_skew * scale[..., None]
    theta = torch.arccos(
        torch.clamp(torch.where(near_pi, cos_theta, torch.zeros_like(cos_theta)), -1.0 + 1e-7, 1.0)
    )
    # near pi: axis from the diagonal of (R + I) / 2 = a a^T
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis2 = torch.clamp((diag + 1.0) * 0.5, min=0.0)
    axis = torch.sqrt(torch.where(near_pi[..., None], torch.clamp(axis2, min=1e-12), torch.ones_like(axis2)))
    axis = torch.where(near_pi[..., None], axis, torch.zeros_like(axis))
    s12 = R[..., 0, 1] + R[..., 1, 0]
    s13 = R[..., 0, 2] + R[..., 2, 0]
    s23 = R[..., 1, 2] + R[..., 2, 1]
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    use_x = (ax >= ay) & (ax >= az)
    use_y = (~use_x) & (ay >= az)
    sy = torch.where(use_x, torch.sign(s12), torch.where(use_y, one, torch.sign(s23)))
    sx = torch.where(use_x, one, torch.where(use_y, torch.sign(s12), torch.sign(s13)))
    sz = torch.where(use_x, torch.sign(s13), torch.where(use_y, torch.sign(s23), one))
    sx = torch.where(sx == 0, one, sx)
    sy = torch.where(sy == 0, one, sy)
    sz = torch.where(sz == 0, one, sz)
    w_pi = torch.stack([sx * ax, sy * ay, sz * az], dim=-1) * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian V of SO3 such that exp_se3((w, u)) has translation V @ u."""
    theta2 = torch.sum(w * w, dim=-1)
    _, B, C = _sinc_coeffs(theta2)
    W = hat(w)
    return _eye3(W) + B[..., None, None] * W + C[..., None, None] * torch.matmul(W, W)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """SE3 exponential: (..., 6) twist (omega, upsilon) -> (..., 4, 4)."""
    w, u = xi[..., :3], xi[..., 3:]
    t = torch.einsum("...ij,...j->...i", so3_left_jacobian(w), u)
    return rt_to_mat(so3_exp(w), t)


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from (..., 3, 3) and (..., 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    # made on the device (no host-to-device copy, so the call can sit in a CUDA graph)
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3]
    bottom = bottom.expand(batch + (4,))[..., None, :]
    return torch.cat([top, bottom], dim=-2)


def mat_to_rt(T: torch.Tensor):
    return T[..., :3, :3], T[..., :3, 3]


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    R, t = mat_to_rt(T)
    Rt = R.transpose(-1, -2)
    return rt_to_mat(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) @ (..., 4, 4) in full fp32."""
    return torch.matmul(A, B)


def reorthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Project the rotation block back onto SO(3) with two Newton steps of the
    polar decomposition, R <- R (3I - R^T R) / 2."""
    R, t = mat_to_rt(T)
    eye3 = _eye3(R)
    for _ in range(2):
        R = torch.matmul(R, 3.0 * eye3 - torch.matmul(R.transpose(-1, -2), R)) * 0.5
    return rt_to_mat(R, t)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to (..., N, 3) (or (..., 3)) points."""
    R, t = mat_to_rt(T)
    pts = pts if pts.dim() >= 2 else pts[None]
    return torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]
