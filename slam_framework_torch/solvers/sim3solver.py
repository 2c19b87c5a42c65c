"""Batched Horn-alignment Sim3 RANSAC for loop closing.

Port of slam_framework_tpu/solvers/sim3solver.py, after Sim3Solver
(src/solvers/sim3solver.{h,cpp}): Horn 1987 closed-form similarity from
3-point sets (:230-341) inside RANSAC (:142-211). Every hypothesis is computed
at once: batched centroids and M matrices, the quaternion from the dominant
eigenvector of the 4x4 N matrix (batched eigh), optional scale (fixed to 1 for
stereo / RGB-D, slam_system.cpp:63-66), then reprojection-error inlier counts
in BOTH images (:344-368) and a Gauss-Newton refinement of the winner.

The random part is split off: `sample_index_sets` draws the (H, S) index sets
on the host from an explicit `torch.Generator`, and `solve_sim3_ransac` takes
them. The card and the CPU then test the same hypotheses, and a test can hand
the same sets to the reference. A triplet with a repeated index gives a
rank-deficient N whose top eigenvector is arbitrary (LAPACK and cuSOLVER
differ there); such a hypothesis gathers no inliers on real data, and only the
winner is carried on.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_framework_torch.geometry import se3, sim3 as s3
from slam_framework_torch.geometry.projection import Intrinsics


class Sim3Result(NamedTuple):
    R: torch.Tensor          # (3,3) rotation mapping frame-2 points into frame 1
    t: torch.Tensor          # (3,)
    s: torch.Tensor          # () scale
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # () int32
    ok: torch.Tensor         # () bool


def sample_index_sets(mask: torch.Tensor, n_hypotheses: int, generator: torch.Generator,
                      set_size: int = 3) -> torch.Tensor:
    """(H, set_size) int64 indices drawn with replacement, uniformly over the
    True entries of the HOST tensor `mask`, from a host generator: the
    distribution of the reference's `jax.random.choice(..., p=mask / sum)`.
    Sim3 draws 3, PnP-2D 6 (`pnp.MIN_SET`), PnP-3D 3."""
    probs = mask.to(torch.float32)
    if not bool(probs.any()):
        return torch.zeros((n_hypotheses, set_size), dtype=torch.long)
    return torch.multinomial(probs, n_hypotheses * set_size, replacement=True,
                             generator=generator).reshape(n_hypotheses, set_size)


def horn_alignment(p1: torch.Tensor, p2: torch.Tensor, fix_scale: bool):
    """Batched Horn closed form: align (..., S, 3) p2 -> p1. Returns R, t, s with
    p1 ~ s * R @ p2 + t."""
    c1 = p1.mean(dim=-2, keepdim=True)
    c2 = p2.mean(dim=-2, keepdim=True)
    q1 = p1 - c1
    q2 = p2 - c2
    M = torch.einsum("...si,...sj->...ij", q2, q1)  # orientation: R maps 2 -> 1
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack(
        [
            torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
            torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
            torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
            torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
        ],
        dim=-2,
    )
    _, vecs = torch.linalg.eigh(N)
    q = vecs[..., :, -1]  # largest eigenvalue -> (w, x, y, z); R is even in q
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )
    if fix_scale:
        s = torch.ones(R.shape[:-2], dtype=R.dtype, device=R.device)
    else:
        # Horn symmetric scale: sqrt(sum|q1|^2 / sum|q2|^2)
        num = torch.sum(q1 * q1, dim=(-1, -2))
        den = torch.clamp(torch.sum(q2 * q2, dim=(-1, -2)), min=1e-12)
        s = torch.sqrt(num / den)
    t = c1[..., 0, :] - s[..., None] * torch.einsum("...ij,...j->...i", R, c2[..., 0, :])
    return R, t, s


def _project(P: torch.Tensor, K: Intrinsics) -> torch.Tensor:
    """(..., 3) camera-frame points -> pixels, depth clamped at 1e-6."""
    z = torch.where(P[..., 2] > 1e-6, P[..., 2], torch.full_like(P[..., 2], 1e-6))
    return torch.stack([K.fx * P[..., 0] / z + K.cx, K.fy * P[..., 1] / z + K.cy], dim=-1)


def solve_sim3_ransac(
    pts1: torch.Tensor,        # (N, 3) points in keyframe-1 camera frame
    pts2: torch.Tensor,        # (N, 3) matched points in keyframe-2 camera frame
    uv1: torch.Tensor,         # (N, 2) pixel measurements in image 1
    uv2: torch.Tensor,         # (N, 2) pixel measurements in image 2
    sigma2_1: torch.Tensor,    # (N,) per-match sigma^2 (image 1 octave)
    sigma2_2: torch.Tensor,    # (N,)
    mask: torch.Tensor,        # (N,) valid matches
    K: Intrinsics,
    idx: torch.Tensor,         # (H, 3) index sets, see sample_index_sets
    fix_scale: bool = True,
    min_inliers: int = 20,     # loop_closer.cpp:339
    err_mult: float = 9.21,    # sim3solver.cpp:89-90
) -> Sim3Result:
    idx = idx.to(pts1.device)
    R, t, s = horn_alignment(pts1[idx], pts2[idx], fix_scale)  # (H,3,3), (H,3), (H,)

    # error in image 1: project s R p2 + t
    p2_in_1 = s[:, None, None] * torch.einsum("hij,nj->hni", R, pts2) + t[:, None, :]
    e1 = torch.sum((_project(p2_in_1, K) - uv1[None]) ** 2, dim=-1)
    # error in image 2: project (1/s) R^T (p1 - t)
    p1_in_2 = torch.einsum("hji,hnj->hni", R, pts1[None] - t[:, None, :]) / s[:, None, None]
    e2 = torch.sum((_project(p1_in_2, K) - uv2[None]) ** 2, dim=-1)
    inl = (e1 < err_mult * sigma2_1[None]) & (e2 < err_mult * sigma2_2[None]) & mask[None]
    counts = inl.sum(dim=1, dtype=torch.int32)
    # the first hypothesis with the highest count, made explicit (see bow/vocabulary.py)
    H = counts.shape[0]
    best = torch.argmax(counts.long() * H + (H - 1 - torch.arange(H, device=counts.device)))
    # Gauss-Newton refinement over the inlier set (OptimizeSim3,
    # loop_closer.cpp:430-440 / optimizer.cpp:962-1152)
    Rb, tb, sb, inl_b, cnt_b = refine_sim3(
        R[best], t[best], s[best], pts1, pts2, uv1, uv2, sigma2_1, sigma2_2, inl[best], K,
        fix_scale=fix_scale, err_mult=err_mult,
    )
    return Sim3Result(R=Rb, t=tb, s=sb, inliers=inl_b, n_inliers=cnt_b, ok=cnt_b >= min_inliers)


def refine_sim3(
    R0: torch.Tensor,
    t0: torch.Tensor,
    s0: torch.Tensor,
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    sigma2_1: torch.Tensor,
    sigma2_2: torch.Tensor,
    mask: torch.Tensor,
    K: Intrinsics,
    fix_scale: bool = True,
    n_iters: int = 10,
    err_mult: float = 9.21,
    huber2: float = 10.0,     # chi2 kernel delta^2 (optimizer.cpp:1019 deltaHuber=sqrt(10))
):
    """Gauss-Newton Sim3 refinement on the reprojection error in BOTH images
    (Optimizer::OptimizeSim3, optimizer.cpp:962-1152): forward updates
    exp(xi) . S of the 7-dof tangent (rotation, translation, log-scale; the
    scale row is pinned when fix_scale), Huber-weighted normal equations,
    inliers re-gated each iteration. Fixed shapes, fixed iteration count; the
    7-column Jacobian at xi = 0 is written out (the reference differentiates
    the residual forward, which costs 7,000 small launches per attempt here)."""
    dev, dtype = pts1.device, torch.float32
    n = pts1.shape[0]
    inv_s2 = torch.cat([1.0 / sigma2_1, 1.0 / sigma2_2])  # (2N,)
    eye7 = torch.eye(7, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev).expand(n, 3, 3)
    keep = torch.ones(7, dtype=dtype, device=dev)
    keep[6] = 0.0
    e_scale = 1.0 - keep
    hat1 = se3.hat(pts1)  # (N, 3, 3)

    def project_rows(P):
        """Pixels of (N, 3) camera-frame points and d pixel / d P (N, 2, 3);
        the depth is clamped at 1e-6 and then carries no derivative."""
        front = P[:, 2] > 1e-6
        z = torch.where(front, P[:, 2], torch.full_like(P[:, 2], 1e-6))
        uv = torch.stack([K.fx * P[:, 0] / z + K.cx, K.fy * P[:, 1] / z + K.cy], dim=-1)
        dz = front.to(dtype) / (z * z)
        zero = torch.zeros_like(z)
        rows = torch.stack([
            torch.stack([K.fx / z, zero, -K.fx * P[:, 0] * dz], dim=-1),
            torch.stack([zero, K.fy / z, -K.fy * P[:, 1] * dz], dim=-1),
        ], dim=-2)
        return uv, rows

    def residuals_jacobian(R, t, s):
        """r (2N, 2) and dr / dxi (2N, 2, 7) at xi = 0 of the update exp(xi) . S:
        a point y = S p2 of image 1 moves by -[y]x w + u + sigma y, and a point
        z = S^-1 p1 of image 2 by (1/s) R^T ([p1]x w - u - sigma p1)."""
        y = s * torch.einsum("ij,nj->ni", R, pts2) + t
        uv_1, rows_1 = project_rows(y)
        dy = torch.cat([-se3.hat(y), eye3, y[:, :, None]], dim=-1)                     # (N, 3, 7)
        z = torch.einsum("ji,nj->ni", R, pts1 - t) / s
        uv_2, rows_2 = project_rows(z)
        dz = torch.einsum("ji,njk->nik", R, torch.cat([hat1, -eye3, -pts1[:, :, None]], dim=-1)) / s
        r = torch.cat([uv_1 - uv1, uv_2 - uv2], dim=0)
        J = torch.cat([torch.matmul(rows_1, dy), torch.matmul(rows_2, dz)], dim=0)
        return r, J

    def chi2_of(r):
        return torch.sum(r * r, dim=-1) * inv_s2

    R, t, s = R0.to(dtype), t0.to(dtype), torch.as_tensor(s0, dtype=dtype, device=dev)
    inl = torch.cat([mask, mask])
    for _ in range(n_iters):
        r, J = residuals_jacobian(R, t, s)
        chi2 = chi2_of(r)
        w_huber = torch.where(chi2 > huber2, torch.sqrt(huber2 / torch.clamp(chi2, min=1e-12)), torch.ones_like(chi2))
        w = inv_s2 * w_huber * inl.to(dtype)
        Hm = torch.einsum("nri,nrj,n->ij", J, J, w)
        g = torch.einsum("nri,nr,n->i", J, r, w)
        if fix_scale:
            # pin the scale direction: zero row + column 7, unit diagonal, zero gradient
            Hm = Hm * keep[:, None] * keep[None, :] + torch.outer(e_scale, e_scale)
            g = g * keep
        delta = -torch.linalg.solve_ex(Hm + 1e-6 * eye7, g)[0]
        S = s3.compose(s3.exp(delta[None]), s3.make(R[None], t[None], s[None]))
        R, t, s = S["R"][0], S["t"][0], S["s"][0]
        # re-gate with the updated transform (chi2 is sigma-scaled, so the gate
        # is err_mult itself, as in the RANSAC inlier test)
        c_new = chi2_of(residuals_jacobian(R, t, s)[0])
        both = (c_new[:n] < err_mult) & (c_new[n:] < err_mult) & mask
        inl = torch.cat([both, both])
    inl = inl[:n]
    return R, t, s, inl, inl.sum(dtype=torch.int32)
