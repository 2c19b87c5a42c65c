"""Pinhole projection and undistortion on torch tensors.

Port of slam_framework_tpu/geometry/projection.py (the parts the stereo
tracking slice uses).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Intrinsics(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    bf: float  # baseline * fx; 0 for mono

    @property
    def baseline(self):
        return self.bf / self.fx


def undistort_points(uv: torch.Tensor, K: Intrinsics, dist, iters: int = 5) -> torch.Tensor:
    """Iterative undistortion of (..., 2) pixel points; dist = (k1, k2, p1, p2, k3)."""
    k1, k2, p1, p2, k3 = (float(c) for c in dist)
    x0 = (uv[..., 0] - K.cx) / K.fx
    y0 = (uv[..., 1] - K.cy) / K.fy
    x, y = x0, y0
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        inv_r = 1.0 / torch.clamp(radial, min=1e-9)
        x = (x0 - dx) * inv_r
        y = (y0 - dy) * inv_r
    return torch.stack([x * K.fx + K.cx, y * K.fy + K.cy], dim=-1)
