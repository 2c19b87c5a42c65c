"""Spatially-uniform keypoint selection: fixed-grid ranked top-K.

Port of slam_framework_tpu/ops/select.py. The score map is tiled into fixed
cells; each cell keeps its K_CELL best responses (low-threshold corners only
where the high threshold found none), and the global pick orders candidates
by (within-cell rank, -score).

Ties: `jax.lax.top_k` keeps the lower index first among equal values, and
level-0 FAST strengths are integers, so ties are common. `torch.topk` orders
ties differently, so `top_k` below is a stable descending sort.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class Selected(NamedTuple):
    xy: torch.Tensor        # (N, 2) int32, (x, y) level pixel coords
    response: torch.Tensor  # (N,) fp32
    valid: torch.Tensor     # (N,) bool


K_CELL = 8  # candidates retained per cell before global ranking


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis; equal
    values keep ascending index order, as jax.lax.top_k does."""
    idx = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(x, -1, idx), idx


def _pad_to_multiple(score: torch.Tensor, cell: int) -> torch.Tensor:
    h, w = score.shape
    ph = (-h) % cell
    pw = (-w) % cell
    if ph or pw:
        score = F.pad(score, (0, pw, 0, ph))
    return score


def select_uniform(
    score_hi: torch.Tensor,
    score_lo: torch.Tensor,
    n_target: int,
    cell: int = 32,
) -> Selected:
    """Pick up to n_target keypoints, spatially uniform across `cell`-px tiles.

    score_hi / score_lo: (H, W) NMS'd corner-strength maps at the high / low
    FAST threshold (0 = not a corner). Returns fixed-size outputs + validity."""
    hi = _pad_to_multiple(score_hi, cell)
    lo = _pad_to_multiple(score_lo, cell)
    ph, pw = hi.shape
    ncy, ncx = ph // cell, pw // cell

    def to_cells(s):
        return s.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3).reshape(ncy * ncx, cell * cell)

    hi_c = to_cells(hi)
    lo_c = to_cells(lo)
    cell_has_hi = hi_c.amax(dim=1) > 0
    sc = torch.where(cell_has_hi[:, None], hi_c, lo_c)

    k = min(K_CELL, cell * cell)
    top_scores, top_idx = top_k(sc, k)  # (ncells, k)

    cell_ids = torch.arange(ncy * ncx, dtype=torch.int64, device=sc.device)
    cy = (cell_ids // ncx)[:, None]
    cx = (cell_ids % ncx)[:, None]
    y = cy * cell + top_idx // cell
    x = cx * cell + top_idx % cell

    rank = torch.arange(k, dtype=torch.float32, device=sc.device)[None, :].expand(top_scores.shape)
    flat_scores = top_scores.reshape(-1)
    flat_rank = rank.reshape(-1)
    flat_x = x.reshape(-1)
    flat_y = y.reshape(-1)
    is_corner = flat_scores > 0

    # key: lower rank first, then higher score; invalid candidates go last
    max_score = 1e6
    key = torch.where(is_corner, flat_rank * max_score - flat_scores,
                      torch.full_like(flat_scores, float("inf")))
    n_pick = min(n_target, key.shape[0])
    _, order = top_k(-key, n_pick)
    sel_x = flat_x[order]
    sel_y = flat_y[order]
    sel_s = flat_scores[order]
    sel_valid = is_corner[order]

    if n_pick < n_target:
        pad = n_target - n_pick
        sel_x = F.pad(sel_x, (0, pad))
        sel_y = F.pad(sel_y, (0, pad))
        sel_s = F.pad(sel_s, (0, pad))
        sel_valid = F.pad(sel_valid, (0, pad))

    xy = torch.stack([sel_x, sel_y], dim=-1).to(torch.int32)
    return Selected(xy=xy, response=sel_s, valid=sel_valid)
