"""Batched mapping ops: epipolar-gated triangulation of new map points and
projection-gated fusion of a keyframe's points into its neighbours.

Port of slam_framework_tpu/pipeline/mapping_ops.py (LocalMapper::
CreateNewMapPoints + OrbMatcher::SearchForTriangulation, local_mapper.cpp:
258-492, and SearchInNeighbors + OrbMatcher::Fuse, :494-554). All neighbours
are processed at once: the (Nn, N, N) epipolar-gated Hamming tensor,
best-per-row matching, batched DLT triangulation and the validity checks as
masked tensors. Where the reference `vmap`s a per-neighbour function
(`_triangulate_pair`, `_fuse_points_one_kf`), the two entry points here carry
the neighbour axis through every step themselves.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_framework_torch.geometry import se3, triangulation
from slam_framework_torch.geometry.projection import Intrinsics
from slam_framework_torch.matching import hamming, matcher
from slam_framework_torch.pipeline import track_ops


class KFBlock(NamedTuple):
    """Feature block of one keyframe (leading axis = neighbour index when stacked)."""

    pose: torch.Tensor    # (..., 4, 4) Tcw
    xy: torch.Tensor      # (..., N, 2)
    ur: torch.Tensor      # (..., N) right-u or -1
    octave: torch.Tensor  # (..., N) int32
    angle: torch.Tensor   # (..., N)
    desc: torch.Tensor    # (..., N, 8) int32 (uint32 bits)
    cand: torch.Tensor    # (..., N) bool — valid feature, not yet associated


def block_from_store(packs, descs, idxs, poses, cand) -> KFBlock:
    """Assemble stacked KFBlocks by gathering keyframe rows from the
    device-resident store (pipeline/kf_store.py).

    packs: (K, N, 9) f32 store; descs: (K, N, 8) int32; idxs: (Nn,) valid
    keyframe slots; poses: (Nn, 4, 4); cand: (Nn, N) bool."""
    idxs = idxs.long()
    rows = torch.index_select(packs, 0, idxs)   # (Nn, N, 9)
    desc = torch.index_select(descs, 0, idxs)   # (Nn, N, 8)
    return KFBlock(
        pose=poses,
        xy=rows[..., 0:2],
        ur=rows[..., 2],
        octave=rows[..., 4].to(torch.int32),
        angle=rows[..., 5],
        desc=desc,
        cand=cand,
    )


def block_at(blocks: KFBlock, index) -> KFBlock:
    """Index or slice every field of a stacked block along the neighbour axis."""
    return KFBlock(*[f[index] for f in blocks])


class TriangulationResult(NamedTuple):
    idx: torch.Tensor     # (Nn, N) int32 — neighbour feature matched to cur feature i
    pts: torch.Tensor     # (Nn, N, 3) world points
    valid: torch.Tensor   # (Nn, N) bool — passed all checks


class CompactTriangulation(NamedTuple):
    """Per-current-feature first-match compaction of TriangulationResult (the
    host write-back only ever uses the first neighbour that matched each feature)."""

    ni: torch.Tensor      # (N,) int32 first matching neighbour index
    nf: torch.Tensor      # (N,) int32 that neighbour's feature index
    pts: torch.Tensor     # (N, 3) world point from that pair
    valid: torch.Tensor   # (N,) bool any neighbour matched


def compact_first_match(res: TriangulationResult) -> CompactTriangulation:
    Nn, N = res.valid.shape
    # the first True along the neighbour axis as a masked minimum of the
    # neighbour index (0 where there is none, as an argmax over booleans gives):
    # an argmax does not promise the first of equal maxima on every device
    n_idx = torch.arange(Nn, device=res.valid.device)[:, None]
    first = torch.where(res.valid, n_idx, torch.full_like(n_idx, Nn)).amin(dim=0)
    any_v = first < Nn
    ni = torch.where(any_v, first, torch.zeros_like(first))
    ar = torch.arange(N, device=res.valid.device)
    return CompactTriangulation(ni=ni.to(torch.int32), nf=res.idx[ni, ar], pts=res.pts[ni, ar], valid=any_v)


def _k_matrix(K: Intrinsics, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([[K.fx, 0.0, K.cx], [0.0, K.fy, K.cy], [0.0, 0.0, 1.0]],
                        dtype=like.dtype, device=like.device)


def _k_inverse(K: Intrinsics, like: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of the upper-triangular pinhole matrix."""
    return torch.tensor([[1.0 / K.fx, 0.0, -K.cx / K.fx], [0.0, 1.0 / K.fy, -K.cy / K.fy], [0.0, 0.0, 1.0]],
                        dtype=like.dtype, device=like.device)


def _fundamental_12(T1w: torch.Tensor, T2w: torch.Tensor, K: Intrinsics) -> torch.Tensor:
    """F12 such that x2^T F12 x1 = 0 (ComputeFundamentalMatrix,
    local_mapper.cpp:615-630, in the x2'Fx1 convention). T2w may be stacked."""
    T21 = se3.compose(T2w, se3.se3_inverse(T1w))
    R = T21[..., :3, :3]
    t = T21[..., :3, 3]
    E = torch.matmul(se3.hat(t), R)
    Kinv = _k_inverse(K, T1w)
    return torch.matmul(torch.matmul(Kinv.T, E), Kinv)


def _epipolar_dist2(F12: torch.Tensor, xy1: torch.Tensor, xy2: torch.Tensor) -> torch.Tensor:
    """(..., N1, N2) squared distance of x2 to the epipolar line of x1
    (CheckDistEpipolarLine, orb_matcher.cpp:~720). F12 and xy2 may be stacked."""
    ones1 = torch.ones((xy1.shape[0], 1), dtype=xy1.dtype, device=xy1.device)
    x1h = torch.cat([xy1, ones1], dim=1)                     # (N1, 3)
    lines = torch.matmul(x1h, F12.transpose(-1, -2))          # (..., N1, 3) line in image 2
    a, b, c = lines[..., 0:1], lines[..., 1:2], lines[..., 2:3]
    # dist^2 = (a u2 + b v2 + c)^2 / (a^2 + b^2)
    val = a * xy2[..., None, :, 0] + b * xy2[..., None, :, 1] + c
    den = torch.clamp(a * a + b * b, min=1e-12)
    return (val * val) / den


def _camera_center(pose: torch.Tensor) -> torch.Tensor:
    return -torch.einsum("...ji,...j->...i", pose[..., :3, :3], pose[..., :3, 3])


def triangulate_with_neighbors(
    cur: KFBlock,
    nbr: KFBlock,
    min_baseline,
    K: Intrinsics,
    num_levels: int = 8,
    scale_factor: float = 1.2,
) -> TriangulationResult:
    """The whole CreateNewMapPoints pass at once: match + triangulate + validate
    the current keyframe `cur` (N, ...) against the stacked neighbour blocks
    `nbr` (Nn, N, ...)."""
    sf2 = scale_factor**2
    f32 = torch.float32
    sigma2_n = sf2 ** nbr.octave.to(f32)                        # (Nn, N)

    # baseline gate (local_mapper.cpp:300-318): skip a neighbour whose camera is too close
    c1 = _camera_center(cur.pose)                                # (3,)
    c2 = _camera_center(nbr.pose)                                # (Nn, 3)
    baseline_ok = torch.linalg.vector_norm(c2 - c1, dim=-1) > min_baseline  # (Nn,)

    F12 = _fundamental_12(cur.pose, nbr.pose, K)                 # (Nn, 3, 3)
    ed2 = _epipolar_dist2(F12, cur.xy, nbr.xy)                   # (Nn, N, N)
    epi_gate = ed2 < 3.84 * sigma2_n[..., None, :]
    oct_gate = matcher.octave_gate(cur.octave, nbr.octave, -1, 1)
    gate = epi_gate & oct_gate & cur.cand[:, None] & nbr.cand[..., None, :]

    ham = hamming.hamming_matrix(cur.desc, nbr.desc)
    # best-per-row like SearchForTriangulation (no mutual gate: epipolar +
    # rotation consistency carry the selectivity)
    res = matcher.gated_match(ham, gate, max_dist=50)
    res = matcher.rotation_consistency(cur.angle, nbr.angle, res)
    res = matcher.resolve_duplicate_columns(res, nbr.xy.shape[-2])

    safe_j = torch.where(res.valid, res.idx, torch.zeros_like(res.idx)).long()  # (Nn, N)
    uv2 = torch.gather(nbr.xy, -2, safe_j[..., None].expand(safe_j.shape + (2,)))

    # projection matrices P = K [R|t]
    Km = _k_matrix(K, cur.pose)
    P1 = torch.matmul(Km, cur.pose[:3, :4])
    P2 = torch.matmul(Km, nbr.pose[..., :3, :4])
    cur_xy = cur.xy.expand(uv2.shape)
    pts = triangulation.triangulate_dlt(P1.expand(P2.shape), P2, cur_xy, uv2)  # (Nn, N, 3)

    # validity (local_mapper.cpp:394-471)
    err1, z1 = triangulation.reprojection_error(P1, pts, cur_xy)
    err2, z2 = triangulation.reprojection_error(P2, pts, uv2)
    sig2_1 = sf2 ** cur.octave.to(f32)
    sig2_2 = torch.gather(sigma2_n, -1, safe_j)
    cosp = triangulation.parallax_cosine(c1, c2, pts)
    d1 = torch.linalg.vector_norm(pts - c1, dim=-1)
    d2 = torch.linalg.vector_norm(pts - c2[..., None, :], dim=-1)
    ratio_factor = 1.5 * scale_factor
    ratio_octave = scale_factor ** (cur.octave.to(f32) - torch.gather(nbr.octave, -1, safe_j).to(f32))
    ratio_dist = d2 / torch.clamp(d1, min=1e-9)
    scale_ok = (ratio_dist < ratio_octave * ratio_factor) & (ratio_dist * ratio_factor > ratio_octave)
    ok = (
        res.valid
        & baseline_ok[..., None]
        & (z1 > 0)
        & (z2 > 0)
        & (cosp < 0.9998)
        & (err1 < 5.991 * sig2_1)
        & (err2 < 5.991 * sig2_2)
        & scale_ok
        & (d1 > 1e-3)
    )
    return TriangulationResult(idx=res.idx, pts=pts, valid=ok)


def fuse_points_into_kfs(
    pt_pos, pt_desc, pt_normal, pt_min_dist, pt_max_dist, pt_mask,
    kf: KFBlock,
    K: Intrinsics,
    num_levels: int = 8,
    scale_factor: float = 1.2,
    image_wh: tuple = (1241, 376),
):
    """SearchInNeighbors' Fuse pass (local_mapper.cpp:494-554) over ALL neighbour
    keyframes at once: project the point set into the stacked keyframes `kf`
    (Nn, ...) and pick, per keyframe feature, the best duplicate-candidate point
    (OrbMatcher::Fuse, orb_matcher.cpp:804-954): in-frustum, dist within
    [min,max], viewing cos > 0.5, radius 3*scale(predicted level), octave within
    +-1, Hamming <= TH_LOW. `kf.cand` = feature-valid (bound features included:
    conflicts become host-side merges). Returns (Nn, F) int32: best point per
    (keyframe, feature), -1 none."""
    u, v, z = track_ops._project(kf.pose, pt_pos, K)             # (Nn, P)
    center = se3.se3_inverse(kf.pose)[..., :3, 3]                # (Nn, 3)
    delta = pt_pos - center[..., None, :]                        # (Nn, P, 3)
    dist = torch.linalg.vector_norm(delta, dim=-1)
    view_cos = torch.sum(delta * pt_normal, dim=-1) / torch.clamp(dist, min=1e-6)
    W, H = image_wh
    in_frustum = (
        pt_mask & (z > 0.1) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        & (dist >= 0.5 * pt_min_dist) & (dist <= 1.5 * pt_max_dist)
        & (view_cos > 0.5)
    )
    lvl = track_ops.predict_scale(dist, pt_max_dist, num_levels)
    radius = 3.0 * (scale_factor ** lvl.to(torch.float32))
    pred_uv = torch.stack([u, v], dim=-1)

    ham = hamming.hamming_matrix(pt_desc, kf.desc)
    gate = (
        matcher.window_gate(pred_uv, kf.xy, radius)
        & matcher.octave_gate(lvl, kf.octave, -1, 1)
        & in_frustum[..., None]
        & kf.cand[..., None, :]
    )
    res = matcher.gated_match(ham, gate, max_dist=track_ops.TH_LOW)
    res = matcher.resolve_duplicate_columns(res, kf.xy.shape[-2])
    return track_ops._invert_matches(res, pt_pos.shape[0], kf.xy.shape[-2])

