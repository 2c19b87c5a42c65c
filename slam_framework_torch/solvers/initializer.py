"""Monocular two-view initializer: batched homography / essential RANSAC + reconstruction.

Port of slam_framework_tpu/solvers/initializer.py (Initializer,
src/util/initializer.{h,cpp}). All hypotheses of both models are solved at once:
the normalized 8-point essential matrix (batched 9x9 `eigh`) and the DLT
homography on the same 8-point sets, both scored with the reference's
symmetric-transfer chi2 (3.841 / 5.991, sigma = 1 px) and picked by
RH = SH / (SH + SF) > 0.40 (:92-98). The best E is refit on its inliers and
decomposed into 4 motions, the best H likewise into the 8 motions of Faugeras
(ReconstructH :568-736); one batched CheckRT (:804-922) validates all 12.

Randomness: the reference draws its (n_hypotheses, 8) sets inside with
`jax.random.choice(key, N, p=mask / sum)`. Here the caller hands them in
(`sample_hypotheses` draws them on the host from a `torch.Generator`), so the
card and the CPU, and a test and the reference, can test the same hypotheses.

Signs: a singular vector or an eigenvector is defined up to its sign, and
cuSOLVER and LAPACK may return opposite ones. `_svd` puts every factorisation
in one canonical form (each column of U has its largest entry positive, the
rows of Vh follow), the 4 motions of E are ordered by a sign-free key (the
twisted pair by trace, the translation with its largest entry positive), and
E / H enter only through expressions that are even in their sign, so the
result does not depend on the library's choice.

Precision: the refits of the best E and H on all their inliers solve a 9x9
normal matrix of ~2,000 rows, whose smallest eigenvector float32 does not
determine: on the bench world's first pair cuSOLVER's put E 0.21 (sign-free,
unit norm) from the float64 solution and LAPACK's 4.5e-4, and the card's E
triangulated 914 good points against the CPU's 1,944 (an H100;
tools/replay_mono_init.py). Both refits form and solve that matrix in float64,
the port's counterpart of the reference's Precision.HIGHEST, so they agree on
every device; the minimal 8-point sets stay in float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from slam_framework_torch.geometry import triangulation
from slam_framework_torch.geometry.projection import Intrinsics
from slam_framework_torch.solvers.sim3solver import sample_index_sets

CHI2_H = 5.991   # initializer.cpp CheckHomography
CHI2_F = 3.841   # CheckFundamental (1-dof transfer)
SCORE_OFFSET = 5.991
N_HYPOTHESES = 200   # initializer.cpp:60 (200 RANSAC sets)
SET_SIZE = 8


class InitResult(NamedTuple):
    R: torch.Tensor          # (3,3) rotation cam1 -> cam2 (Tcw of frame 2, frame 1 = I)
    t: torch.Tensor          # (3,) unit-norm translation
    points: torch.Tensor     # (N, 3) triangulated points in frame-1 camera coords
    good: torch.Tensor       # (N,) bool: triangulated + validated matches
    n_good: torch.Tensor     # () int32
    is_planar: torch.Tensor  # () bool: the H model won (reconstructed via Faugeras)
    ok: torch.Tensor         # () bool


def sample_hypotheses(mask: torch.Tensor, generator: torch.Generator,
                      n_hypotheses: int = N_HYPOTHESES) -> torch.Tensor:
    """(n_hypotheses, 8) int64 match indices drawn with replacement, uniformly
    over the True entries of the HOST mask (the reference's draw's distribution)."""
    return sample_index_sets(mask, n_hypotheses, generator, set_size=SET_SIZE)


def _library_svd(A: torch.Tensor):
    return torch.linalg.svd(A)


def _svd(A: torch.Tensor):
    """SVD with every singular-vector pair's sign fixed: the largest-magnitude
    entry of each column of U is positive (the first one on a tie), and the
    matching row of Vh is flipped with it, so U diag(s) Vh is unchanged."""
    U, s, Vh = _library_svd(A)
    lead = torch.argmax(U.abs(), dim=-2, keepdim=True)          # (..., 1, 3)
    sign = torch.where(torch.gather(U, -2, lead) < 0, -1.0, 1.0)  # (..., 1, 3)
    return U * sign, s, Vh * sign.transpose(-1, -2)


def _smallest_eigvec(AtA: torch.Tensor) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue (its sign is arbitrary; every use
    below is even in it)."""
    return torch.linalg.eigh(AtA)[1][..., :, 0]


def _normalize(uv: torch.Tensor, K: Intrinsics) -> torch.Tensor:
    return torch.stack([(uv[..., 0] - K.cx) / K.fx, (uv[..., 1] - K.cy) / K.fy], dim=-1)


def _epipolar_rows(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            x2[..., 0] * x1[..., 0], x2[..., 0] * x1[..., 1], x2[..., 0],
            x2[..., 1] * x1[..., 0], x2[..., 1] * x1[..., 1], x2[..., 1],
            x1[..., 0], x1[..., 1], torch.ones_like(x1[..., 0]),
        ],
        dim=-1,
    )


def _project_essential(E: torch.Tensor) -> torch.Tensor:
    """Nearest essential matrix: singular values (1, 1, 0)."""
    U, _, Vh = _svd(E)
    D = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return torch.matmul(U * D, Vh)


def _eight_point_E(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Batched essential matrix from (..., 8, 2) normalized correspondences."""
    a = _epipolar_rows(x1, x2)  # (..., 8, 9)
    AtA = torch.einsum("...ki,...kj->...ij", a, a)
    E = _smallest_eigvec(AtA).reshape(x1.shape[:-2] + (3, 3))
    return _project_essential(E)


def _eight_point_E_weighted(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Essential matrix from ALL correspondences with per-row weights (N,),
    solved in float64 (see the module docstring) and returned in x1's dtype."""
    f64 = torch.float64
    a = _epipolar_rows(x1.to(f64), x2.to(f64)) * w.to(f64)[:, None]
    AtA = torch.einsum("ki,kj->ij", a, a)
    return _project_essential(_smallest_eigvec(AtA).reshape(3, 3)).to(x1.dtype)


def _dlt_rows(x1: torch.Tensor, x2: torch.Tensor):
    xh = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)  # (..., S, 3)
    zeros = torch.zeros_like(xh)
    rows_u = torch.cat([xh, zeros, -x2[..., 0:1] * xh], dim=-1)
    rows_v = torch.cat([zeros, xh, -x2[..., 1:2] * xh], dim=-1)
    return rows_u, rows_v


def _dlt_H(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Batched homography from (..., S, 2) normalized correspondences (DLT)."""
    rows_u, rows_v = _dlt_rows(x1, x2)
    A = torch.cat([rows_u, rows_v], dim=-2)  # (..., 2S, 9)
    AtA = torch.einsum("...ki,...kj->...ij", A, A)
    return _smallest_eigvec(AtA).reshape(x1.shape[:-2] + (3, 3))


def _dlt_H_weighted(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Homography from ALL correspondences with per-row weights (N,): the
    inlier-weighted refit mirroring the E path's, in float64 as that one is."""
    f64 = torch.float64
    w = w.to(f64)
    rows_u, rows_v = _dlt_rows(x1.to(f64), x2.to(f64))
    A = torch.cat([rows_u * w[:, None], rows_v * w[:, None]], dim=0)
    AtA = torch.einsum("ki,kj->ij", A, A)
    return _smallest_eigvec(AtA).reshape(3, 3).to(x1.dtype)


def _sampson_chi2(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor, K: Intrinsics) -> torch.Tensor:
    """Per-match squared epipolar (Sampson) error in pixels^2 for each hypothesis.
    E: (H, 3, 3); x1 / x2: (N, 2) normalized."""
    ones = torch.ones_like(x1[:, :1])
    p1 = torch.cat([x1, ones], dim=-1)
    p2 = torch.cat([x2, ones], dim=-1)
    Ep1 = torch.einsum("hij,nj->hni", E, p1)
    Etp2 = torch.einsum("hji,nj->hni", E, p2)
    x2tEp1 = torch.sum(p2[None] * Ep1, dim=-1)
    denom = Ep1[..., 0] ** 2 + Ep1[..., 1] ** 2 + Etp2[..., 0] ** 2 + Etp2[..., 1] ** 2
    return (x2tEp1 ** 2) / torch.clamp(denom, min=1e-12) * (K.fx ** 2)


def _transfer_chi2_H(Hm: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor, K: Intrinsics) -> torch.Tensor:
    """Symmetric transfer error of homographies (H, 3, 3), pixels^2."""
    ones = torch.ones_like(x1[:, :1])
    p1 = torch.cat([x1, ones], dim=-1)
    p2 = torch.cat([x2, ones], dim=-1)

    def xfer(M, pa, pb):
        q = torch.einsum("hij,nj->hni", M, pa)
        qz = torch.where(torch.abs(q[..., 2]) < 1e-9, torch.full_like(q[..., 2], 1e-9), q[..., 2])
        return (q[..., 0] / qz - pb[None, :, 0]) ** 2 + (q[..., 1] / qz - pb[None, :, 1]) ** 2

    eye = torch.eye(3, dtype=Hm.dtype, device=Hm.device)
    Hinv = torch.linalg.inv_ex(Hm + 1e-12 * eye)[0]
    return (xfer(Hm, p1, p2) + xfer(Hinv, p2, p1)) * (K.fx ** 2) * 0.5


def _decompose_H(Hn: torch.Tensor):
    """Faugeras SVD decomposition of a normalized homography into 8 (R, t) motions
    (ReconstructH, initializer.cpp:568-736): Rs (8,3,3), unit ts (8,3) and the
    reference's degenerate-spectrum flag (d1 ~ d2 or d2 ~ d3, :601-604), on
    which the caller rejects all 8."""
    U, d, Vh = _svd(Hn)
    s = torch.linalg.det(U) * torch.linalg.det(Vh)
    d1, d2, d3 = d[0], d[1], d[2]
    dev, dt = Hn.device, Hn.dtype
    denom13 = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / denom13, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / denom13, min=0.0))
    eps1 = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=dt, device=dev)
    eps3 = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=dt, device=dev)
    x1v = eps1 * aux1
    x3v = eps3 * aux3
    zero4 = torch.zeros(4, dtype=dt, device=dev)
    one4 = torch.ones(4, dtype=dt, device=dev)

    def rot_y(c, sgn_s, flip: float):
        # (4,3,3); flip=+1: [[c,0,-s],[0,1,0],[s,0,c]]; flip=-1: [[c,0,s],[0,-1,0],[s,0,-c]]
        c4 = c * one4
        return torch.stack(
            [
                torch.stack([c4, zero4, -flip * sgn_s], -1),
                torch.stack([zero4, flip * one4, zero4], -1),
                torch.stack([sgn_s, zero4, flip * c4], -1),
            ],
            dim=-2,
        )

    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    # case d' = +d2 (initializer.cpp:597-635)
    den_t = torch.clamp((d1 + d3) * d2, min=1e-12)
    Rp_pos = rot_y((d2 * d2 + d1 * d3) / den_t, eps1 * eps3 * root / den_t, 1.0)
    tp_pos = (d1 - d3) * torch.stack([x1v, zero4, -x3v], -1)
    # case d' = -d2 (initializer.cpp:637-676)
    den_p = (d1 - d3) * d2
    den_p = torch.where(torch.abs(den_p) < 1e-12, torch.full_like(den_p, 1e-12), den_p)
    Rp_neg = rot_y((d1 * d3 - d2 * d2) / den_p, eps1 * eps3 * root / den_p, -1.0)
    tp_neg = (d1 + d3) * torch.stack([x1v, zero4, x3v], -1)

    Rp = torch.cat([Rp_pos, Rp_neg], dim=0)  # (8,3,3)
    tp = torch.cat([tp_pos, tp_neg], dim=0)  # (8,3)
    Rs = s * torch.einsum("ij,mjk,kl->mil", U, Rp, Vh)
    ts = torch.einsum("ij,mj->mi", U, tp)
    ts = ts / torch.clamp(torch.linalg.vector_norm(ts, dim=-1, keepdim=True), min=1e-12)
    degenerate = (d1 / torch.clamp(d2, min=1e-12) < 1.00001) | (d2 / torch.clamp(d3, min=1e-12) < 1.00001)
    return Rs, ts, degenerate


def _decompose_E(E: torch.Tensor):
    """ReconstructF's 4 motions (initializer.cpp:459-566) of an essential matrix:
    (R1, t), (R1, -t), (R2, t), (R2, -t). The twisted pair is ordered by trace
    and t has its largest entry positive, so the order is free of the SVD's signs."""
    U, _, Vh = _svd(E)
    # proper rotations
    U = U * torch.sign(torch.linalg.det(U))
    Vh = Vh * torch.sign(torch.linalg.det(Vh))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype, device=E.device)
    Ra = U @ W @ Vh
    Rb = U @ W.T @ Vh
    swap = torch.diagonal(Rb).sum() > torch.diagonal(Ra).sum()
    R1 = torch.where(swap, Rb, Ra)
    R2 = torch.where(swap, Ra, Rb)
    tu = U[:, 2] / torch.clamp(torch.linalg.vector_norm(U[:, 2]), min=1e-12)
    tu = torch.where(tu[torch.argmax(tu.abs())] < 0, -tu, tu)
    return torch.stack([R1, R1, R2, R2]), torch.stack([tu, -tu, tu, -tu])


def _check_motions(Rs, ts, x1, x2, mask, K: Intrinsics, sigma: float):
    """CheckRT (initializer.cpp:804-922) batched over M motion hypotheses:
    triangulate each hypothesis's inlier matches, validate cheirality in both
    views (waived for near-zero-parallax points, :871-879) and reprojection;
    `good` also requires cosParallax < 0.99998 (:906-907); the parallax
    statistic is the angle of the 50th smallest cosParallax among the counted
    points (:911-917). mask: (N,) or (M, N).
    Returns (pts (M,N,3), good (M,N), ngood (M,), parallax_deg (M,))."""
    M, N = Rs.shape[0], x1.shape[0]
    dev, dt = Rs.device, Rs.dtype
    if mask.dim() == 1:
        mask = mask[None].expand(M, N)
    P1 = torch.cat([torch.eye(3, dtype=dt, device=dev), torch.zeros((3, 1), dtype=dt, device=dev)], dim=1)
    P2 = torch.cat([Rs, ts[..., None]], dim=-1)  # (M, 3, 4)
    pts = triangulation.triangulate_dlt(P1.expand(M, 3, 4), P2, x1[None].expand(M, N, 2),
                                        x2[None].expand(M, N, 2))  # (M, N, 3) frame-1 coords
    z1 = pts[..., 2]
    Xc2 = torch.einsum("mij,mnj->mni", Rs, pts) + ts[:, None, :]
    z2 = Xc2[..., 2]

    def _safe(z):
        return torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)

    e1 = torch.sum((pts[..., :2] / _safe(z1)[..., None] - x1[None]) ** 2, dim=-1) * K.fx ** 2
    e2 = torch.sum((Xc2[..., :2] / _safe(z2)[..., None] - x2[None]) ** 2, dim=-1) * K.fx ** 2
    cosp = triangulation.parallax_cosine(torch.zeros((M, 3), dtype=dt, device=dev),
                                         -torch.einsum("mji,mj->mi", Rs, ts), pts)
    has_parallax = cosp < 0.99998  # initializer.cpp:871 cheirality waiver bound
    counted = (
        ((z1 > 0) | ~has_parallax) & ((z2 > 0) | ~has_parallax)
        & (e1 < 4.0 * sigma ** 2) & (e2 < 4.0 * sigma ** 2)
        & torch.isfinite(pts).all(dim=-1)
        & mask
    )
    ngood = counted.sum(dim=1, dtype=torch.int32)
    good = counted & has_parallax
    # 50th smallest cosParallax among the counted (the largest one when fewer)
    cosp_sorted = torch.sort(torch.where(counted, cosp, torch.full_like(cosp, math.inf)), dim=1).values
    idx50 = torch.clamp(ngood - 1, min=0, max=50).long()
    c50 = torch.gather(cosp_sorted, 1, idx50[:, None])[:, 0]
    parallax_deg = torch.rad2deg(torch.arccos(torch.clamp(c50, -1.0, 1.0)))
    parallax_deg = torch.where(ngood > 0, parallax_deg, torch.zeros_like(parallax_deg))
    return pts, good, ngood, parallax_deg


def initialize_two_view(
    uv1: torch.Tensor,     # (N, 2) pixels in frame 1
    uv2: torch.Tensor,     # (N, 2) matched pixels in frame 2
    mask: torch.Tensor,    # (N,) valid matches
    K: Intrinsics,
    sets: torch.Tensor,    # (n_hypotheses, 8) int64 match indices (sample_hypotheses)
    sigma: float = 1.0,
    min_good: int = 50,        # minTriangulated (tracker.cpp:335 passes 50)
    min_parallax_deg: float = 1.0,
) -> InitResult:
    N = uv1.shape[0]
    dev = uv1.device
    sets = sets.to(dev)
    x1 = _normalize(uv1, K)
    x2 = _normalize(uv2, K)
    mask = mask.to(torch.bool)

    # --- essential path
    E = _eight_point_E(x1[sets], x2[sets])
    chi2_e = _sampson_chi2(E, x1, x2, K) / sigma ** 2
    inl_e = (chi2_e < CHI2_F) & mask[None]
    # the reference's score: sum of (offset - chi2) over the inliers (CheckFundamental)
    score_e = torch.where(inl_e, SCORE_OFFSET - chi2_e, torch.zeros_like(chi2_e)).sum(dim=1)
    best_e = torch.argmax(score_e)
    inl_best_e = inl_e[best_e]
    # refit on the best hypothesis's inliers: the minimal-set E is noise-limited
    E_refit = _eight_point_E_weighted(x1, x2, inl_best_e.to(x1.dtype))

    # --- homography path (same sets)
    Hm = _dlt_H(x1[sets], x2[sets])
    chi2_h = _transfer_chi2_H(Hm, x1, x2, K) / sigma ** 2
    inl_h = (chi2_h < CHI2_H) & mask[None]
    score_h = torch.where(inl_h, CHI2_H - chi2_h, torch.zeros_like(chi2_h)).sum(dim=1)

    SH = score_h.max()
    SF = score_e.max()
    RH = SH / torch.clamp(SH + SF, min=1e-9)
    is_planar = RH > 0.40  # initializer.cpp:95

    Rs_e, ts_e = _decompose_E(E_refit)
    best_h = torch.argmax(score_h)
    inl_best_h = inl_h[best_h]
    Rs_h, ts_h, h_degenerate = _decompose_H(_dlt_H_weighted(x1, x2, inl_best_h.to(x1.dtype)))

    # all 12 motions through one CheckRT, each model over its OWN RANSAC inliers;
    # the RH rule then picks which model's winner is returned (:92-98)
    Rs = torch.cat([Rs_e, Rs_h], dim=0)   # (12,3,3)
    ts = torch.cat([ts_e, ts_h], dim=0)
    model_mask = torch.cat([(inl_best_e & mask)[None].expand(4, N), (inl_best_h & mask)[None].expand(8, N)], dim=0)
    pts, good, ngood, parallax_deg = _check_motions(Rs, ts, x1, x2, model_mask, K, sigma)
    model_h = torch.arange(12, device=dev) >= 4
    minus1 = torch.full_like(ngood, -1)
    # degenerate-spectrum early-out (initializer.cpp:601-604): reject all 8 H motions
    ngood = torch.where(model_h & h_degenerate, minus1, ngood)
    ngood_model = torch.where(model_h == is_planar, ngood, minus1)
    best_m = torch.argmax(ngood_model)
    n_best = ngood_model[best_m]
    n_bestf = n_best.to(torch.float32)
    # the reference's acceptance, per model:
    #   E (ReconstructF :500-516): maxGood >= max(0.9*N, minTriangulated), no second
    #     motion with nGood > 0.7*maxGood, the winner's parallax > minParallax;
    #   H (ReconstructH :706-735): bestGood > 0.9*N, secondBest < 0.75*bestGood,
    #     parallax > minParallax, bestGood > minTriangulated.
    n_model_inl = torch.where(is_planar, (inl_best_h & mask).sum(), (inl_best_e & mask).sum()).to(torch.float32)
    n_similar_e = (ngood_model.to(torch.float32) > 0.7 * n_bestf).sum()
    second = torch.sort(ngood_model).values[-2].to(torch.float32)
    clear_winner = torch.where(is_planar, second < 0.75 * n_bestf, n_similar_e <= 1)
    ok = (
        (n_best >= min_good)
        & (n_bestf > 0.9 * n_model_inl)
        & clear_winner
        & (parallax_deg[best_m] > min_parallax_deg)
    )
    return InitResult(
        R=Rs[best_m], t=ts[best_m], points=pts[best_m], good=good[best_m],
        n_good=n_best, is_planar=is_planar, ok=ok,
    )
