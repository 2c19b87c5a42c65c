"""Per-frame tracking associations + pose optimizations.

Port of slam_framework_tpu/pipeline/track_ops.py: motion-model association
(SearchByProjection against the last frame), local-map association (frustum
cull + SearchByProjection against the point block), the reference-keyframe
fallback (global descriptor matching), and duplicate-point fusion candidates.
Dense Hamming matrices + gate masks replace the reference's grid lookups.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from slam_framework_torch.geometry import se3
from slam_framework_torch.geometry.projection import Intrinsics
from slam_framework_torch.matching import hamming, matcher
from slam_framework_torch.optim import pose_opt
from slam_framework_torch.pipeline.frame import FrameData

TH_HIGH = 100
TH_LOW = 50


class TrackResult(NamedTuple):
    pose: torch.Tensor        # (4,4) optimized Tcw
    assoc: torch.Tensor       # (N_cur,) int32 — index into the point block, -1 if none
    inlier: torch.Tensor      # (N_cur,) bool — assoc survived pose optimization
    n_matches: torch.Tensor   # () int32 matches fed to the optimizer
    n_inliers: torch.Tensor   # () int32 inliers after optimization
    visible: Optional[torch.Tensor] = None  # (P,) bool — block point in frustum


class PointBlock(NamedTuple):
    """Fixed-capacity block of map points on the device for association."""

    pos: torch.Tensor        # (P, 3)
    desc: torch.Tensor       # (P, 8) int32 (uint32 bits)
    normal: torch.Tensor     # (P, 3) mean viewing direction (world)
    min_dist: torch.Tensor   # (P,)
    max_dist: torch.Tensor   # (P,)
    mask: torch.Tensor       # (P,) bool


def _obs_from_assoc(cur: FrameData, pts: torch.Tensor, assoc: torch.Tensor) -> pose_opt.PoseObs:
    """Fixed-shape PoseObs: one slot per current feature."""
    matched = assoc >= 0
    safe = torch.where(matched, assoc, torch.zeros_like(assoc)).long()
    return pose_opt.PoseObs(
        points_w=pts[safe],
        uv=cur.xy,
        ur=torch.where(matched & (cur.u_right >= 0), cur.u_right, torch.full_like(cur.u_right, -1.0)),
        inv_sigma2=1.0 / (1.2 ** (2.0 * cur.octave.to(torch.float32))),
        mask=matched,
    )


def predict_scale(dist: torch.Tensor, max_dist: torch.Tensor, num_levels: int = 8,
                  log_sf: float = 0.1823215568) -> torch.Tensor:
    """MapPoint::PredictScale: level from the distance ratio."""
    ratio = torch.clamp(max_dist / torch.clamp(dist, min=1e-6), min=1e-6)
    lvl = torch.ceil(torch.log(ratio) / log_sf)
    return torch.clamp(lvl, 0, num_levels - 1).to(torch.int32)


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=torch.int32)


def track_motion(
    cur: FrameData,
    pred_pose: torch.Tensor,
    last_pts: torch.Tensor,     # (N_last, 3) world positions of last frame's points
    last_desc: torch.Tensor,    # (N_last, 8)
    last_octave: torch.Tensor,  # (N_last,)
    last_angle: torch.Tensor,   # (N_last,)
    last_mask: torch.Tensor,    # (N_last,) bool — slot has a map point
    K: Intrinsics,
    th: float = 7.0,
    num_levels: int = 8,
    scale_factor: float = 1.2,
) -> TrackResult:
    """SearchByProjection(F, LastFrame) + PoseOptimization. Window radius
    th * scale(last octave); the doubled radius is taken when the narrow
    search yields < 20 matches (both are computed, then selected)."""
    sf = scale_factor ** last_octave.to(torch.float32)
    u, v, z = _project(pred_pose, last_pts, K)
    in_front = z > 0.1
    pred_uv = torch.stack([u, v], dim=-1)

    ham = hamming.hamming_matrix(last_desc, cur.desc)
    base_gate = (matcher.octave_gate(last_octave, cur.octave, -1, 1)
                 & last_mask[:, None] & cur.valid[None, :] & in_front[:, None])

    def run(radius_mult):
        gate = matcher.window_gate(pred_uv, cur.xy, radius_mult * th * sf) & base_gate
        res = matcher.gated_match(ham, gate, max_dist=TH_HIGH)
        return matcher.rotation_consistency(last_angle, cur.angle, res)

    res1 = run(1.0)
    res2 = run(2.0)
    use_wide = res1.count < 20
    res = matcher.MatchResult(
        idx=torch.where(use_wide, res2.idx, res1.idx),
        dist=torch.where(use_wide, res2.dist, res1.dist),
        valid=torch.where(use_wide, res2.valid, res1.valid),
    )
    res = matcher.resolve_duplicate_columns(res, cur.capacity)
    assoc = _invert_matches(res, last_pts.shape[0], cur.capacity)
    obs = _obs_from_assoc(cur, last_pts, assoc)
    opt = pose_opt.optimize_pose(pred_pose, obs, K, n_rounds=3, n_iters=4)
    return TrackResult(pose=opt.pose, assoc=assoc, inlier=opt.inliers,
                       n_matches=_count(assoc >= 0), n_inliers=opt.num_inliers)


def _frustum_geometry(pose: torch.Tensor, block: PointBlock, K: Intrinsics):
    u, v, z = _project(pose, block.pos, K)
    cam_center = se3.se3_inverse(pose)[:3, 3]
    delta = block.pos - cam_center[None, :]
    dist = torch.linalg.vector_norm(delta, dim=-1)
    return u, v, z, delta, dist


def track_local_map(
    cur: FrameData,
    pose: torch.Tensor,
    prior_assoc: torch.Tensor,   # (N_cur,) int32 into `block` (from motion tracking), -1 none
    block: PointBlock,
    K: Intrinsics,
    th: float = 1.0,
    num_levels: int = 8,
    scale_factor: float = 1.2,
    image_wh: tuple = (1241, 376),
) -> TrackResult:
    """Frustum-cull + SearchByProjection(local map) + PoseOptimization."""
    u, v, z, delta, dist = _frustum_geometry(pose, block, K)
    view_cos = torch.sum(delta * block.normal, dim=-1) / torch.clamp(dist, min=1e-6)
    W, H = image_wh
    in_frustum = (
        block.mask & (z > 0.1) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        & (dist >= 0.8 * block.min_dist) & (dist <= 1.2 * block.max_dist) & (view_cos > 0.5)
    )
    lvl = predict_scale(dist, block.max_dist, num_levels)
    radius = torch.where(view_cos > 0.998, torch.full_like(view_cos, 2.5), torch.full_like(view_cos, 4.0)) \
        * (scale_factor ** lvl.to(torch.float32)) * th
    pred_uv = torch.stack([u, v], dim=-1)

    ham = hamming.hamming_matrix(block.desc, cur.desc)
    already = prior_assoc >= 0
    gate = (
        matcher.window_gate(pred_uv, cur.xy, radius)
        & matcher.octave_gate(lvl, cur.octave, -1, 1)
        & in_frustum[:, None]
        & cur.valid[None, :]
        & ~already[None, :]   # don't steal features associated by motion tracking
    )
    # the reference's 0.9 nn-ratio is deliberately off here (see the JAX module)
    res = matcher.gated_match(ham, gate, max_dist=TH_HIGH)
    res = matcher.resolve_duplicate_columns(res, cur.capacity)
    assoc = _invert_matches(res, block.pos.shape[0], cur.capacity)
    assoc = torch.where(already, prior_assoc, assoc)
    obs = _obs_from_assoc(cur, block.pos, assoc)
    opt = pose_opt.optimize_pose(pose, obs, K, n_rounds=3, n_iters=4)
    return TrackResult(pose=opt.pose, assoc=assoc, inlier=opt.inliers,
                       n_matches=_count(assoc >= 0), n_inliers=opt.num_inliers, visible=in_frustum)


def track_reference_fallback(
    cur: FrameData,
    last_pose: torch.Tensor,      # (4,4) last tracked frame's pose (NOT extrapolated)
    block: PointBlock,
    K: Intrinsics,
) -> TrackResult:
    """TrackReferenceKeyFrame: GLOBAL descriptor matching against the block
    (mutual best, 0.7 nn-ratio, TH_LOW), then optimize from the last pose."""
    ham = hamming.hamming_matrix(block.desc, cur.desc)
    gate = block.mask[:, None] & cur.valid[None, :]
    res = matcher.gated_match(ham, gate, max_dist=TH_LOW, nn_ratio=0.7, mutual=True)
    res = matcher.resolve_duplicate_columns(res, cur.capacity)
    assoc = _invert_matches(res, block.pos.shape[0], cur.capacity)
    obs = _obs_from_assoc(cur, block.pos, assoc)
    opt = pose_opt.optimize_pose(last_pose, obs, K, n_rounds=4, n_iters=6)
    return TrackResult(pose=opt.pose, assoc=assoc, inlier=opt.inliers,
                       n_matches=_count(assoc >= 0), n_inliers=opt.num_inliers)


def fuse_candidates(
    cur: FrameData,
    pose: torch.Tensor,
    assoc: torch.Tensor,          # (N_cur,) current associations into `block` (-1 none)
    block: PointBlock,
    K: Intrinsics,
    num_levels: int = 8,
    scale_factor: float = 1.2,
    image_wh: tuple = (1241, 376),
) -> torch.Tensor:
    """Per unassociated feature: the block point it re-detects, or -1
    (OrbMatcher::Fuse semantics: radius 4 * scale(level), Hamming <= TH_LOW,
    octave +-1, stereo depth within 20%)."""
    u, v, z, _, dist = _frustum_geometry(pose, block, K)
    W, H = image_wh
    in_frustum = (
        block.mask & (z > 0.1) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        & (dist >= 0.5 * block.min_dist) & (dist <= 1.5 * block.max_dist)
    )
    lvl = predict_scale(dist, block.max_dist, num_levels)
    radius = 4.0 * (scale_factor ** lvl.to(torch.float32))
    pred_uv = torch.stack([u, v], dim=-1)

    ham = hamming.hamming_matrix(block.desc, cur.desc)
    has_d = cur.depth > 0
    depth_ok = (~has_d)[None, :] | (
        torch.abs(z[:, None] - cur.depth[None, :]) < 0.2 * torch.clamp(z[:, None], min=1.0)
    )
    gate = (
        matcher.window_gate(pred_uv, cur.xy, radius)
        & matcher.octave_gate(lvl, cur.octave, -1, 1)
        & in_frustum[:, None]
        & cur.valid[None, :]
        & depth_ok
        & (assoc < 0)[None, :]
    )
    res = matcher.gated_match(ham, gate, max_dist=TH_LOW)
    res = matcher.resolve_duplicate_columns(res, cur.capacity)
    return _invert_matches(res, block.pos.shape[0], cur.capacity)


def _invert_matches(res: matcher.MatchResult, n_rows: int, n_cols: int) -> torch.Tensor:
    """Row->col matches to per-column best row index (-1 none), dense
    (argmin over an (R, C) masked distance matrix; lowest row wins ties)."""
    cols = torch.arange(n_cols, dtype=torch.int32, device=res.idx.device)
    chose = res.valid[:, None] & (res.idx[:, None] == cols[None, :])
    d = torch.where(chose, res.dist[:, None], torch.full_like(chose, matcher.BIG, dtype=res.dist.dtype))
    best, best_row = torch.min(d, dim=0)
    best_row = best_row.to(torch.int32)
    return torch.where(best < matcher.BIG, best_row, torch.full_like(best_row, -1))


def _project(Tcw: torch.Tensor, pts: torch.Tensor, K: Intrinsics):
    Xc = se3.transform_points(Tcw, pts)
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    return K.fx * x / z_safe + K.cx, K.fy * y / z_safe + K.cy, z
