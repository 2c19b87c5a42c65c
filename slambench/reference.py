"""The plain reference that decides `correct`: NumPy only.

It imports nothing of the program, of the JAX package or of any library but
NumPy, and takes nothing the program made except the outputs it judges:

- `fast_nms`: FAST-9/16 corner strength (the largest threshold at which a
  pixel is still a corner: the max over the 16 arcs of 9 of the least signed
  difference, bright and dark) with edge-replicated reads, then a strict 3x3
  non-maximum suppression; in float32, as the front-end states it;
- `pyramid`: the ORB pyramid from a level-0 image, each level the bilinear
  (half-pixel centre) resize of the one before, in float64;
- `align`, `ate`: camera centres aligned by Umeyama (SE3, or Sim3 where the
  scale is free) and their RMSE; `motion_errors`: the translation error of
  relative motions;
- `surface_distance`: a world point's distance to the nearest surface of the
  drive's corridor (two cylinders concentric with the arc and the ground).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# Bresenham circle of radius 3, clockwise from 12 o'clock: (dy, dx).
CIRCLE = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
          (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))
ARC = 9


def fast_nms(img: np.ndarray) -> np.ndarray:
    """NMS'd FAST-9 strength of one (H, W) float32 image."""
    img = np.asarray(img, np.float32)
    h, w = img.shape
    pad = np.pad(img, 3, mode="edge")
    diffs = np.stack([pad[3 + dy: 3 + dy + h, 3 + dx: 3 + dx + w] for dy, dx in CIRCLE]) - img[None]

    def arc_strength(d):
        # m9[k] = min(d[k], ..., d[k + 8]) around the circle, by doubling steps
        m2 = np.minimum(d, np.roll(d, -1, axis=0))
        m4 = np.minimum(m2, np.roll(m2, -2, axis=0))
        m8 = np.minimum(m4, np.roll(m4, -4, axis=0))
        return np.minimum(m8, np.roll(d, -(ARC - 1), axis=0)).max(axis=0)

    strength = np.maximum(arc_strength(diffs), arc_strength(-diffs))
    padded = np.pad(strength, 1, mode="constant", constant_values=-np.inf)
    neigh = np.full((h, w), -np.inf, np.float32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                np.maximum(neigh, padded[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w], out=neigh)
    return np.where(strength > neigh, strength, np.float32(0.0)).astype(np.float32)


def level_shapes(height: int, width: int, num_levels: int, scale_factor: float) -> List[Tuple[int, int]]:
    return [(int(round(height / scale_factor ** lvl)), int(round(width / scale_factor ** lvl)))
            for lvl in range(num_levels)]


def _resize_axis(img: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    n_in = img.shape[axis]
    src = np.clip((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    w_hi = src - lo
    a, b = np.take(img, lo, axis=axis), np.take(img, hi, axis=axis)
    shape = [1, 1]
    shape[axis] = n_out
    w_hi = w_hi.reshape(shape)
    return a * (1.0 - w_hi) + b * w_hi


def pyramid(img: np.ndarray, num_levels: int, scale_factor: float) -> List[np.ndarray]:
    """float64 levels of one (H, W) image, level 0 the image itself."""
    shapes = level_shapes(img.shape[0], img.shape[1], num_levels, scale_factor)
    levels = [np.asarray(img, np.float64)]
    for h, w in shapes[1:]:
        levels.append(_resize_axis(_resize_axis(levels[-1], h, 0), w, 1))
    return levels


def centres(Tcw: np.ndarray) -> np.ndarray:
    """(N, 3) camera centres of (N, 4, 4) Tcw."""
    T = np.asarray(Tcw, np.float64)
    R, t = T[:, :3, :3], T[:, :3, 3]
    return -np.einsum("nji,nj->ni", R, t)


def align(src: np.ndarray, dst: np.ndarray, with_scale: bool) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares R, t, s with dst ~ s R src + t (Umeyama 1991)."""
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    xs, xd = src - mu_s, dst - mu_d
    U, D, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / max((xs ** 2).sum() / len(src), 1e-12)) if with_scale else 1.0
    return R, mu_d - s * R @ mu_s, s


def ate(est_cw: np.ndarray, gt_cw: np.ndarray, with_scale: bool) -> Tuple[float, float]:
    """RMSE of aligned camera centres (metres of the ground truth) and the scale used."""
    e, g = centres(est_cw), centres(gt_cw)
    R, t, s = align(e, g, with_scale)
    err = np.linalg.norm((s * (R @ e.T)).T + t - g, axis=1)
    return float(np.sqrt(np.mean(err ** 2))), s


def motion_errors(est_a: np.ndarray, est_b: np.ndarray, gt_a: np.ndarray, gt_b: np.ndarray,
                  scale: float) -> np.ndarray:
    """Translation error of each relative motion a -> b (Tcw pairs), the
    estimate's scaled by `scale` (metres of the ground truth)."""
    rel_e = np.asarray(est_b, np.float64) @ np.linalg.inv(np.asarray(est_a, np.float64))
    rel_g = np.asarray(gt_b, np.float64) @ np.linalg.inv(np.asarray(gt_a, np.float64))
    return np.linalg.norm(scale * rel_e[:, :3, 3] - rel_g[:, :3, 3], axis=1)


def surface_distance(points: np.ndarray, center: Tuple[float, float], r_inner: float, r_outer: float,
                     ground_y: float) -> np.ndarray:
    """Distance of each (N, 3) world point to the nearest corridor surface."""
    p = np.asarray(points, np.float64)
    rho = np.hypot(p[:, 0] - center[0], p[:, 2] - center[1])
    return np.minimum(np.minimum(np.abs(rho - r_inner), np.abs(rho - r_outer)), np.abs(p[:, 1] - ground_y))
