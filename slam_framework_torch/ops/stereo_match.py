"""Rectified stereo matching: row-banded Hamming search + SAD subpixel refinement.

Port of slam_framework_tpu/ops/stereo_match.py: (N_l, N_r) Hamming matrix gated
by row band, octave and disparity; best match under TH_STEREO; 11x11 SAD over
+-5 shifts on a pyramid atlas with a parabola fit; 1.5 * 1.4 * median SAD cut.
The median averages the two middle values, as jnp.nanmedian does
(`torch.nanquantile(., 0.5)`, not `torch.nanmedian`).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from slam_framework_torch.geometry.projection import Intrinsics
from slam_framework_torch.matching import hamming, matcher
from slam_framework_torch.ops.brief import slice_windows
from slam_framework_torch.ops.extractor import Features

SAD_W = 5          # half window -> 11x11 (frame.cpp:495)
SAD_L = 5          # search slides -> +-5 (frame.cpp:496)
TH_STEREO = 75     # (TH_HIGH + TH_LOW) / 2 (frame.cpp:466 area)


class StereoMatches(NamedTuple):
    u_right: torch.Tensor  # (N,) fp32, -1 where unmatched
    depth: torch.Tensor    # (N,) fp32, -1 where unmatched


def match_stereo(
    left: Features,
    right: Features,
    left_pyr: List[torch.Tensor],
    right_pyr: List[torch.Tensor],
    K: Intrinsics,
    scale_factors,
) -> StereoMatches:
    """scale_factors: (L,) fp32 per-octave scale (1.2^l)."""
    dev = left.xy.device
    sf = torch.as_tensor(np.asarray(scale_factors, np.float32), device=dev)
    oct_ = left.octave.long()
    scale_l = sf[oct_]

    ham = hamming.hamming_matrix(left.desc, right.desc)

    vl = left.xy[:, 1]
    vr = right.xy[:, 1]
    row_gate = torch.abs(vl[:, None] - vr[None, :]) <= (2.0 * scale_l)[:, None]
    oct_gate = matcher.octave_gate(left.octave, right.octave, -1, 1)
    min_disp = 0.0
    max_disp = K.bf / max(K.baseline, 1e-6)  # = fx: disparity at depth = baseline
    disp = left.xy[:, 0][:, None] - right.xy[None, :, 0]
    disp_gate = (disp >= min_disp) & (disp <= max_disp)
    valid_gate = left.valid[:, None] & right.valid[None, :]

    res = matcher.gated_match(ham, row_gate & oct_gate & disp_gate & valid_gate, max_dist=TH_STEREO)

    safe_j = torch.where(res.valid, res.idx, torch.zeros_like(res.idx)).long()
    ur0 = right.xy[safe_j, 0]

    # Subpixel SAD on a pyramid ATLAS (all levels stacked vertically)
    W, Lr = SAD_W, SAD_L
    W0 = left_pyr[0].shape[1]
    row_off_np = np.cumsum([0] + [lp_.shape[0] for lp_ in left_pyr[:-1]])
    atlas_l = torch.cat([F.pad(lp_, (0, W0 - lp_.shape[1])) for lp_ in left_pyr], dim=0)
    atlas_r = torch.cat([F.pad(rp_, (0, W0 - rp_.shape[1])) for rp_ in right_pyr], dim=0)
    row_off = torch.as_tensor(row_off_np, dtype=torch.int32, device=dev)
    lvl_h = torch.as_tensor([lp_.shape[0] for lp_ in left_pyr], dtype=torch.int32, device=dev)
    lvl_w = torch.as_tensor([lp_.shape[1] for lp_ in left_pyr], dtype=torch.int32, device=dev)

    inv_s = 1.0 / scale_l
    xl = torch.round(left.xy[:, 0] * inv_s).to(torch.int32)
    yl = torch.round(left.xy[:, 1] * inv_s).to(torch.int32)
    xr = torch.round(ur0 * inv_s).to(torch.int32)

    h_l, w_l = lvl_h[oct_], lvl_w[oct_]
    in_bounds = (
        (xl >= W) & (xl <= w_l - 1 - W)
        & (yl >= W) & (yl <= h_l - 1 - W)
        & (xr >= W + Lr) & (xr <= w_l - 1 - W - Lr)
    )
    sad_on = res.valid & in_bounds
    y_at = torch.clamp(yl + row_off[oct_], W, atlas_l.shape[0] - 1 - W)
    xl_c = torch.clamp(xl, W, W0 - 1 - W)
    xr_c = torch.clamp(xr, W + Lr, W0 - 1 - W - Lr)

    lw = slice_windows(atlas_l[None], y_at - W, xl_c - W, 2 * W + 1, 2 * W + 1)[0]
    rs = slice_windows(atlas_r[None], y_at - W, xr_c - W - Lr, 2 * W + 1, 2 * W + 1 + 2 * Lr)[0]
    lw = lw - lw[:, W: W + 1, W: W + 1]
    sads = []
    for s in range(2 * Lr + 1):
        rw = rs[:, :, s: s + 2 * W + 1]
        rw = rw - rw[:, W: W + 1, W: W + 1]
        sads.append(torch.sum(torch.abs(lw - rw), dim=(1, 2)))
    sads = torch.stack(sads, dim=1)  # (N, 2L+1)
    best_v, best_s = torch.min(sads, dim=1)
    interior = (best_s > 0) & (best_s < 2 * Lr)
    sm1 = torch.gather(sads, 1, torch.clamp(best_s - 1, min=0)[:, None])[:, 0]
    sp1 = torch.gather(sads, 1, torch.clamp(best_s + 1, max=2 * Lr)[:, None])[:, 0]
    denom = torch.clamp(2.0 * (sm1 + sp1 - 2.0 * best_v), min=1e-6)
    delta = torch.clamp((sm1 - sp1) / denom, -1.0, 1.0)
    ur_sub = (xr.to(torch.float32) + (best_s - Lr).to(torch.float32) + delta) * scale_l

    minus1 = torch.full_like(ur_sub, -1.0)
    use = sad_on & interior
    best_ur = torch.where(use, ur_sub, minus1)
    sad_best = torch.where(sad_on, best_v, torch.full_like(best_v, float("inf")))

    matched = res.valid & use
    disparity = left.xy[:, 0] - best_ur
    matched &= (disparity >= min_disp) & (disparity < max_disp)
    disparity = torch.clamp(disparity, min=0.01)

    # median-based outlier cut on SAD distances (frame.cpp:555-570)
    median = torch.nanquantile(torch.where(matched, sad_best, torch.full_like(sad_best, float("nan"))), 0.5)
    median = torch.where(torch.isnan(median), torch.full_like(median, float("inf")), median)
    keep = matched & (sad_best <= 1.5 * 1.4 * median)

    depth = torch.where(keep, K.bf / disparity, minus1)
    u_right = torch.where(keep, best_ur, minus1)
    return StereoMatches(u_right=u_right, depth=depth)
