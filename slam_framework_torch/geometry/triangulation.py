"""Batched two-view DLT triangulation.

Port of slam_framework_tpu/geometry/triangulation.py. Whole match tensors are
triangulated at once: the inhomogeneous least-squares system (w = 1) of the
row-normalised 4x4 DLT matrix is solved by three unrolled Householder
reflections of pure elementwise math and a back-substitution. A batched
library factorisation of thousands of 4x4 systems would be slower and would
round differently in fp32, so the elementwise QR is kept as it is.
"""

from __future__ import annotations

import torch


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor) -> torch.Tensor:
    """Batched DLT: P1/P2 (..., 3, 4) projection matrices, uv1/uv2 (..., N, 2)
    pixels. Returns (..., N, 3) world points."""

    def two_rows(P, uv):
        u = uv[..., 0:1]
        v = uv[..., 1:2]
        r0 = u * P[..., None, 2, :] - P[..., None, 0, :]
        r1 = v * P[..., None, 2, :] - P[..., None, 1, :]
        return r0, r1

    a0, a1 = two_rows(P1, uv1)
    a2, a3 = two_rows(P2, uv2)
    A = torch.stack([a0, a1, a2, a3], dim=-2)  # (..., N, 4, 4)
    # row-normalise: raw rows carry fx-scale entries whose squares eat the mantissa
    A = A / torch.clamp(torch.linalg.vector_norm(A, dim=-1, keepdim=True), min=1e-12)
    Mb = torch.cat([A[..., :3], -A[..., 3:4]], dim=-1)  # (..., N, 4, 4) [M | b]
    rows = torch.arange(4, device=A.device)
    for k in range(3):
        col = Mb[..., :, k]
        x = torch.where(rows >= k, col, torch.zeros_like(col))
        nx = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
        xk = x[..., k : k + 1]
        alpha = torch.where(xk >= 0, -nx, nx)
        e = (rows == k).to(Mb.dtype)
        v = x - alpha * e
        vn2 = torch.clamp(torch.sum(v * v, dim=-1, keepdim=True), min=1e-30)
        vtM = torch.sum(v[..., :, None] * Mb, dim=-2)  # (..., N, 4)
        Mb = Mb - 2.0 * v[..., :, None] * vtM[..., None, :] / vn2[..., None]

    def _safe(d):
        return torch.where(torch.abs(d) < 1e-20, torch.full_like(d, 1e-20), d)

    x2 = Mb[..., 2, 3] / _safe(Mb[..., 2, 2])
    x1 = (Mb[..., 1, 3] - Mb[..., 1, 2] * x2) / _safe(Mb[..., 1, 1])
    x0 = (Mb[..., 0, 3] - Mb[..., 0, 1] * x1 - Mb[..., 0, 2] * x2) / _safe(Mb[..., 0, 0])
    return torch.stack([x0, x1, x2], dim=-1)


def reprojection_error(P: torch.Tensor, pts: torch.Tensor, uv: torch.Tensor):
    """Project (..., N, 3) world points with (..., 3, 4) P; returns the squared
    pixel error against uv (..., N, 2) and the projective depth."""
    # P @ [X; 1] as three fused multiply-adds per row (a K=4 matrix product)
    proj = (
        P[..., None, :, 0] * pts[..., 0:1]
        + P[..., None, :, 1] * pts[..., 1:2]
        + P[..., None, :, 2] * pts[..., 2:3]
        + P[..., None, :, 3]
    )
    z = proj[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = proj[..., 0] / z_safe
    v = proj[..., 1] / z_safe
    err2 = (u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2
    return err2, z


def parallax_cosine(c1: torch.Tensor, c2: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """cos of the ray angle between camera centres c1, c2 (..., 3) at points (..., N, 3)."""
    r1 = pts - c1[..., None, :]
    r2 = pts - c2[..., None, :]
    n1 = torch.linalg.vector_norm(r1, dim=-1)
    n2 = torch.linalg.vector_norm(r2, dim=-1)
    return torch.sum(r1 * r2, dim=-1) / torch.clamp(n1 * n2, min=1e-12)
