"""Batched PnP RANSAC for relocalization.

Port of slam_framework_tpu/solvers/pnp.py, after PnPsolver
(src/solvers/pnp_solver.{h,cpp}): every hypothesis is solved at once. The
monocular solver takes 6-point sets and the 11-dof DLT camera resection
(smallest eigenvector of the 12x12 normal matrix, batched `eigh`); the stereo
solver takes 3-point sets, the Horn SE3 closed form from stereo
back-projections, snapped to the 2-D observations by a few reprojection
Gauss-Newton steps. Both score every correspondence per hypothesis, refine the
best one on its consensus and hand the pose to the caller's motion-only BA.

As in `sim3solver`, the random part is split off: both solvers take the (H, S)
index sets (`sim3solver.sample_index_sets`), so the card and the CPU test the
same hypotheses. A set with a repeated index is rank-deficient and its
eigenvector arbitrary (LAPACK and cuSOLVER differ there); only the winner is
carried on. The reference's `jnp.median` over the six depths of a set is the
mean of the two middle values, i.e. `torch.quantile(., 0.5)`, not
`torch.median`'s lower one. The reference's `_weighted_horn` is referenced
nowhere and is not carried.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_framework_torch.geometry import se3
from slam_framework_torch.geometry.projection import Intrinsics
from slam_framework_torch.solvers.sim3solver import horn_alignment

MIN_SET = 6


class PnPResult(NamedTuple):
    pose: torch.Tensor       # (4, 4) best Tcw
    inliers: torch.Tensor    # (N,) bool for the best hypothesis
    n_inliers: torch.Tensor  # () int32
    ok: torch.Tensor         # () bool — enough inliers found


def _first_argmax(counts: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum (jnp.argmax's rule, made explicit)."""
    H = counts.shape[0]
    return torch.argmax(counts.long() * H + (H - 1 - torch.arange(H, device=counts.device)))


def _pose_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    pose = torch.eye(4, dtype=R.dtype, device=R.device)
    pose[:3, :3] = R
    pose[:3, 3] = t
    return pose


def _orthonormalize(Rp: torch.Tensor, tp: torch.Tensor):
    """Nearest rotation of the (..., 3, 3) DLT block and its translation
    divided by the mean singular value (the DLT's scale)."""
    U, s, Vh = torch.linalg.svd(Rp)
    det = torch.linalg.det(U @ Vh)
    D = torch.cat([torch.ones(det.shape + (2,), dtype=Rp.dtype, device=Rp.device), det[..., None]], dim=-1)
    R_ortho = (U * D[..., None, :]) @ Vh
    return R_ortho, tp / torch.clamp(s.mean(dim=-1), min=1e-12)[..., None]


def _dlt_rows(Xn: torch.Tensor, uv_norm: torch.Tensor) -> torch.Tensor:
    """The two DLT rows of each correspondence, stacked: (..., 2S, 12)."""
    Xh = torch.cat([Xn, torch.ones(Xn.shape[:-1] + (1,), dtype=Xn.dtype, device=Xn.device)], dim=-1)
    zeros = torch.zeros_like(Xh)
    u = uv_norm[..., 0:1]
    v = uv_norm[..., 1:2]
    row_u = torch.cat([Xh, zeros, -u * Xh], dim=-1)
    row_v = torch.cat([zeros, Xh, -v * Xh], dim=-1)
    return torch.cat([row_u, row_v], dim=-2)


def _dlt_resection(pts_w: torch.Tensor, uv_norm: torch.Tensor):
    """Batched DLT: (..., S, 3) world points + (..., S, 2) normalized image
    coordinates -> R (..., 3, 3), t (..., 3): Hartley-normalized points,
    cheirality sign from the median depth of the set, SVD orthonormalization."""
    mean = pts_w.mean(dim=-2, keepdim=True)
    spread = torch.linalg.vector_norm(pts_w - mean, dim=-1).mean(dim=-1)
    s_n = torch.clamp(spread, min=1e-6)[..., None, None]
    A = _dlt_rows((pts_w - mean) / s_n, uv_norm)
    AtA = torch.einsum("...ki,...kj->...ij", A, A)
    _, vecs = torch.linalg.eigh(AtA)
    Pn = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 4))  # smallest eigenvector
    # undo the normalization: P = Pn @ [[I/s, -mean/s], [0, 1]]
    Rp = Pn[..., :3] / s_n
    tp = Pn[..., 3] - torch.einsum("...ij,...j->...i", Rp, mean[..., 0, :])
    # cheirality: the majority of the set must lie in front of the camera
    z = torch.einsum("...ij,...sj->...si", Rp, pts_w)[..., 2] + tp[..., None, 2]
    flip = torch.quantile(z, 0.5, dim=-1) < 0
    sgn = torch.where(flip, -1.0, 1.0).to(Rp.dtype)
    return _orthonormalize(Rp * sgn[..., None, None], tp * sgn[..., None])


def _dlt_resection_weighted(pts_w: torch.Tensor, uv_norm: torch.Tensor, w: torch.Tensor):
    """One DLT resection over ALL correspondences with per-row weights (N, 1)."""
    wsum = torch.clamp(w.sum(), min=1e-6)
    mean = (pts_w * w).sum(dim=0) / wsum
    spread = (torch.linalg.vector_norm(pts_w - mean, dim=-1) * w[:, 0]).sum() / wsum
    s_n = torch.clamp(spread, min=1e-6)
    A = _dlt_rows((pts_w - mean) / s_n, uv_norm)
    A = A * torch.cat([w, w], dim=0)
    _, vecs = torch.linalg.eigh(A.T @ A)
    Pn = vecs[:, 0].reshape(3, 4)
    Rp = Pn[:, :3] / s_n
    tp = Pn[:, 3] - Rp @ mean
    z = pts_w @ Rp[2] + tp[2]
    flip = torch.where(w[:, 0] > 0, torch.sign(z), torch.zeros_like(z)).sum() < 0
    sgn = torch.where(flip, -1.0, 1.0).to(Rp.dtype)
    return _orthonormalize(Rp * sgn, tp * sgn)


def _score(R, t, pts_w, uv, inv_sigma2, mask, K: Intrinsics, thresh: float):
    """Inlier flags (..., N) of pose(s) R, t (chi2 of the reprojection under
    `thresh`, depth above 5 cm, a valid slot) and the predicted depths (..., N)."""
    Xc = torch.einsum("...ij,nj->...ni", R, pts_w) + t[..., None, :]
    z = Xc[..., 2]
    z_safe = torch.where(z > 1e-6, z, torch.full_like(z, 1e-6))
    up = K.fx * Xc[..., 0] / z_safe + K.cx
    vp = K.fy * Xc[..., 1] / z_safe + K.cy
    err2 = ((up - uv[:, 0]) ** 2 + (vp - uv[:, 1]) ** 2) * inv_sigma2
    return (err2 < thresh) & (z > 0.05) & mask, z


def solve_pnp_ransac(
    pts_w: torch.Tensor,        # (N, 3) world points
    uv: torch.Tensor,           # (N, 2) pixel observations
    inv_sigma2: torch.Tensor,   # (N,) per-observation information (octave)
    mask: torch.Tensor,         # (N,) valid correspondences
    K: Intrinsics,
    idx: torch.Tensor,          # (H, MIN_SET) index sets, see sample_index_sets
    chi2_thresh: float = 16.0,
    min_inliers: int = 10,      # tracker.cpp:871
) -> PnPResult:
    """All-hypotheses-at-once PnP RANSAC. Returns the best hypothesis."""
    idx = idx.to(pts_w.device)
    sel_uv = uv[idx]
    uvn = torch.stack([(sel_uv[..., 0] - K.cx) / K.fx, (sel_uv[..., 1] - K.cy) / K.fy], dim=-1)
    R, t = _dlt_resection(pts_w[idx], uvn)  # (H, 3, 3), (H, 3)

    def score(R, t, thresh):
        inl, _ = _score(R, t, pts_w, uv, inv_sigma2, mask, K, thresh)
        return inl, inl.sum(dim=-1, dtype=torch.int32)

    # stage 1: loose consensus (a minimal-set DLT is noise-amplifying, so a
    # strict gate would find none; the loose one separates the right basin)
    inl_l, counts_l = score(R, t, 15.0**2)
    best = _first_argmax(counts_l)
    Rb, tb, inl_b = R[best], t[best], inl_l[best]
    # stage 2: masked all-point DLT on the consensus, shrinking the gate
    uvn_all = torch.stack([(uv[:, 0] - K.cx) / K.fx, (uv[:, 1] - K.cy) / K.fy], dim=-1)
    for thresh in (8.0**2, 4.0**2):
        Rb, tb = _dlt_resection_weighted(pts_w, uvn_all, inl_b.to(pts_w.dtype)[:, None])
        inl_b, _ = score(Rb, tb, thresh)
    # final consensus, looser than the reference's chi2 5.991: the motion-only
    # BA that follows re-classifies every match anyway
    inl, n = score(Rb, tb, chi2_thresh)
    return PnPResult(pose=_pose_matrix(Rb, tb), inliers=inl, n_inliers=n, ok=n >= min_inliers)


def _gn_refine_pose(R, t, Xw, uv, w, K: Intrinsics, iters: int = 5, damping: float = 1e-3):
    """Batched Gauss-Newton on the reprojection error of pose hypotheses.

    R (..., 3, 3), t (..., 3); Xw (..., M, 3) world points; uv (..., M, 2)
    observations; w (..., M) weights (0 disables a row). Left-perturbation SE3
    steps. A singular system leaves the hypothesis as it was: `solve_ex`
    neither raises nor reads its status back, and a non-finite step is
    discarded."""
    eye6 = torch.eye(6, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        Xc = torch.einsum("...ij,...mj->...mi", R, Xw) + t[..., None, :]
        x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
        zs = torch.clamp(z, min=1e-3)
        u = K.fx * x / zs + K.cx
        v = K.fy * y / zs + K.cy
        r = torch.stack([u - uv[..., 0], v - uv[..., 1]], dim=-1)   # (..., M, 2)
        zero = torch.zeros_like(zs)
        Jp = torch.stack([
            torch.stack([K.fx / zs, zero, -K.fx * x / (zs * zs)], dim=-1),
            torch.stack([zero, K.fy / zs, -K.fy * y / (zs * zs)], dim=-1),
        ], dim=-2)                                                  # (..., M, 2, 3)
        Jx = torch.cat([torch.eye(3, dtype=R.dtype, device=R.device).expand(Xc.shape[:-1] + (3, 3)),
                        -se3.hat(Xc)], dim=-1)                      # (..., M, 3, 6)
        J = Jp @ Jx                                                 # (..., M, 2, 6)
        wv = w[..., None, None]
        A = (torch.einsum("...mij,...mik->...mjk", J, J) * wv).sum(dim=-3) + damping * eye6
        b = (torch.einsum("...mij,...mi->...mj", J, r) * wv[..., 0]).sum(dim=-2)
        delta = torch.linalg.solve_ex(A, b[..., None])[0][..., 0]  # (..., 6)
        dR = se3.so3_exp(-delta[..., 3:6])
        R2 = dR @ R
        t2 = torch.einsum("...ij,...j->...i", dR, t) - delta[..., 0:3]
        good = torch.isfinite(delta).all(dim=-1)
        R = torch.where(good[..., None, None], R2, R)
        t = torch.where(good[..., None], t2, t)
    return R, t


def solve_pnp3d_ransac(
    pts_w: torch.Tensor,        # (N, 3) matched map points (world)
    pts_c: torch.Tensor,        # (N, 3) frame keypoints back-projected through stereo depth
    uv: torch.Tensor,           # (N, 2) pixel observations
    inv_sigma2: torch.Tensor,   # (N,)
    mask: torch.Tensor,         # (N,) valid correspondences WITH depth
    K: Intrinsics,
    idx: torch.Tensor,          # (H, 3) index sets, see sample_index_sets
    chi2_thresh: float = 16.0,
    min_inliers: int = 10,
) -> PnPResult:
    """Stereo relocalization pose: 3-point Horn SE3 alignment per hypothesis,
    each snapped to its three 2-D observations by reprojection Gauss-Newton
    (the back-projected depth is metres off at far range, the pixels are not),
    scored with a stereo-depth consistency gate that separates the true pose
    from a corridor-texture alias, refined on the consensus."""
    idx = idx.to(pts_w.device)
    H = idx.shape[0]
    R, t, _ = horn_alignment(pts_c[idx], pts_w[idx], fix_scale=True)  # (H,3,3), (H,3)
    R, t = _gn_refine_pose(R, t, pts_w[idx], uv[idx],
                           torch.ones((H, idx.shape[1]), dtype=pts_w.dtype, device=pts_w.device), K, iters=6)
    z_obs = pts_c[:, 2]

    def score(R, t, thresh):
        inl, z = _score(R, t, pts_w, uv, inv_sigma2, mask, K, thresh)
        dz_ok = (z - z_obs).abs() < 0.2 * torch.clamp(z_obs, min=1.0) + 0.5
        inl = inl & dz_ok
        return inl, inl.sum(dim=-1, dtype=torch.int32)

    inl_l, counts_l = score(R, t, 10.0**2)
    best = _first_argmax(counts_l)
    Rb, tb, inl_b = R[best], t[best], inl_l[best]
    for thresh in (6.0**2, chi2_thresh):
        # refine on the consensus set, again on the reprojection
        Rb, tb = _gn_refine_pose(Rb, tb, pts_w, uv, inl_b.to(pts_w.dtype) * inv_sigma2, K, iters=3)
        inl_b, _ = score(Rb, tb, thresh)
    n = inl_b.sum(dtype=torch.int32)
    return PnPResult(pose=_pose_matrix(Rb, tb), inliers=inl_b, n_inliers=n, ok=n >= min_inliers)
