"""Seeded synthetic BA problems at chosen capacities: local and global.

Cameras on a line looking at a point cloud, the first camera fixed at its true
pose, the others and the points perturbed; every point is seen by
`obs_per_point` cameras drawn at random, with pixel noise, in stereo. The
construction follows the reference package's own BA test scene, sized up to the
default capacities (32 cameras, 4096 points, 16384 observation slots, 8 per
point) and vectorised. `build_global_problem` lays the same scene out as a
global-BA problem (it adds the per-camera observation slots) at the size of
the bench world's map when its loop closes: 80 keyframes and 17,665 points in
128 camera, 32,768 point and 131,072 observation slots.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from slam_framework_torch.geometry.projection import Intrinsics

K_SYNTHETIC = Intrinsics(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=270.0)


class SyntheticBA(NamedTuple):
    arrays: dict            # the fields of optim.local_ba.BAProblem as numpy arrays
    poses_true: np.ndarray  # (n_cams, 4, 4)
    pts_true: np.ndarray    # (n_pts, 3)


def _so3_exp(w: np.ndarray) -> np.ndarray:
    theta = float(np.linalg.norm(w))
    W = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if theta < 1e-9:
        return np.eye(3) + W
    return np.eye(3) + np.sin(theta) / theta * W + (1.0 - np.cos(theta)) / theta**2 * (W @ W)


def build_problem(seed: int = 0, n_cams: int = 24, n_pts: int = 4000, obs_per_point: int = 4,
                  C: int = 32, P: int = 4096, M: int = 16384, O: int = 8,
                  noise_px: float = 0.3, pose_noise: float = 0.02, pt_noise: float = 0.05,
                  K: Intrinsics = K_SYNTHETIC) -> SyntheticBA:
    assert n_cams <= C and n_pts <= P and obs_per_point <= min(O, n_cams) and n_pts * obs_per_point <= M
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-10, 10, n_pts), rng.uniform(-5, 5, n_pts), rng.uniform(8, 30, n_pts)], -1)
    poses_true = np.tile(np.eye(4), (n_cams, 1, 1))
    step = 6.0 / n_cams  # the line of cameras spans 3 m, as 6 cameras at 0.5 m do
    for i in range(n_cams):
        poses_true[i, :3, 3] = [-step * i, 0.02 * step * i, 0.1 * step * i]
        poses_true[i, :3, :3] = _so3_exp(np.array([0.004, 0.008, -0.002]) * step * i)

    # every point: obs_per_point distinct cameras, in ascending order
    cam_of = np.sort(np.argsort(rng.random((n_pts, n_cams)), axis=1)[:, :obs_per_point], axis=1)
    m = n_pts * obs_per_point
    obs_cam = np.zeros(M, np.int32)
    obs_pt = np.zeros(M, np.int32)
    obs_uv = np.zeros((M, 2), np.float32)
    obs_ur = np.full(M, -1.0, np.float32)
    obs_mask = np.zeros(M, bool)
    obs_cam[:m] = cam_of.reshape(-1)
    obs_pt[:m] = np.repeat(np.arange(n_pts), obs_per_point)
    T = poses_true[obs_cam[:m]]
    Xc = np.einsum("mij,mj->mi", T[:, :3, :3], pts[obs_pt[:m]]) + T[:, :3, 3]
    u = K.fx * Xc[:, 0] / Xc[:, 2] + K.cx + rng.normal(0, noise_px, m)
    v = K.fy * Xc[:, 1] / Xc[:, 2] + K.cy + rng.normal(0, noise_px, m)
    obs_uv[:m] = np.stack([u, v], -1)
    obs_ur[:m] = u - K.bf / Xc[:, 2] + rng.normal(0, noise_px, m)
    obs_mask[:m] = True
    pt_slots = np.full((P, O), -1, np.int32)
    pt_slots[:n_pts, :obs_per_point] = np.arange(m, dtype=np.int32).reshape(n_pts, obs_per_point)

    cam_pose = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    cam_pose[:n_cams] = poses_true
    for c in range(1, n_cams):  # perturb all but the first
        xi = rng.normal(size=6) * pose_noise
        dT = np.eye(4)
        dT[:3, :3] = _so3_exp(xi[:3])
        dT[:3, 3] = xi[3:]
        cam_pose[c] = dT @ poses_true[c]
    cam_fixed = np.ones(C, bool)
    cam_fixed[1:n_cams] = False
    cam_mask = np.zeros(C, bool)
    cam_mask[:n_cams] = True
    pt_pos = np.zeros((P, 3), np.float32)
    pt_pos[:n_pts] = pts + rng.normal(0, pt_noise, (n_pts, 3))
    pt_mask = np.zeros(P, bool)
    pt_mask[:n_pts] = True
    arrays = dict(
        cam_pose=cam_pose, cam_fixed=cam_fixed, cam_mask=cam_mask, pt_pos=pt_pos, pt_mask=pt_mask,
        obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=obs_uv, obs_ur=obs_ur,
        obs_inv_sigma2=np.ones(M, np.float32), obs_mask=obs_mask, pt_obs_slots=pt_slots,
    )
    return SyntheticBA(arrays=arrays, poses_true=poses_true.astype(np.float32), pts_true=pts.astype(np.float32))


def build_global_problem(seed: int = 0, n_cams: int = 80, n_pts: int = 17665, obs_per_point: int = 6,
                         C: int = 128, P: int = 32768, M: int = 131072, O: int = 16, **kw) -> SyntheticBA:
    """The fields of optim.global_ba.GlobalBAProblem: `build_problem`'s scene plus
    `cam_obs_slots` (C, Oc), each camera's observations in ascending order, Oc the
    next power of two above the fullest camera (2048 at the default size)."""
    syn = build_problem(seed, n_cams=n_cams, n_pts=n_pts, obs_per_point=obs_per_point, C=C, P=P, M=M, O=O, **kw)
    a = syn.arrays
    m = int(a["obs_mask"].sum())
    order = np.argsort(a["obs_cam"][:m], kind="stable")
    counts = np.bincount(a["obs_cam"][:m], minlength=C)
    Oc = 1
    while Oc < counts.max():
        Oc <<= 1
    cam_slots = np.full((C, Oc), -1, np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for c in range(n_cams):
        cam_slots[c, : counts[c]] = order[starts[c]: starts[c + 1]]
    return syn._replace(arrays={**a, "cam_obs_slots": cam_slots})
