"""Trajectory export (KITTI format) + ATE evaluation with SE3/Sim3 alignment.

Replaces SlamSystem::SaveTrajectoryKITTI / SaveKeyFrameTrajectory
(reference: src/slam_system.cpp:264-349) and the qualitative plot tool
(tools/python_plot.py) with a metric ATE harness (the quantity BASELINE.md tracks).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def save_kitti(path: str, poses_cw: np.ndarray) -> None:
    """Write per-frame camera-to-world poses (Twc = inv(Tcw)) as KITTI 3x4 rows."""
    with open(path, "w") as f:
        for Tcw in poses_cw:
            Twc = np.linalg.inv(Tcw)
            row = Twc[:3, :].reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")


def load_kitti(path: str) -> np.ndarray:
    """Read KITTI pose file -> (F, 4, 4) Twc."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (len(rows), 1, 1))
    out[:, :3, :] = rows
    return out


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = False
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares R, t, s aligning src -> dst (both (N, 3)). Umeyama 1991."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate_rmse(
    est_cw: np.ndarray,
    gt_cw: np.ndarray,
    align: str = "se3",
) -> float:
    """Absolute trajectory error (RMSE of camera centers) after alignment.

    est_cw/gt_cw: (F, 4, 4) Tcw arrays of equal length.
    align: 'none' | 'se3' | 'sim3' (sim3 for monocular scale ambiguity).
    """
    est_c = np.stack([np.linalg.inv(T)[:3, 3] for T in est_cw])
    gt_c = np.stack([np.linalg.inv(T)[:3, 3] for T in gt_cw])
    if align != "none":
        R, t, s = umeyama_alignment(est_c, gt_c, with_scale=(align == "sim3"))
        est_c = (s * (R @ est_c.T)).T + t
    err = np.linalg.norm(est_c - gt_c, axis=1)
    return float(np.sqrt(np.mean(err**2)))
