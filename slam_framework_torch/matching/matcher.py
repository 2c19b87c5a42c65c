"""Gated descriptor matching — the one primitive behind the tracking matchers.

Port of slam_framework_tpu/matching/matcher.py: build the (N, M) Hamming
matrix, AND it with a boolean gate matrix of geometric windows, then masked
row argmin + filters as dense tensor ops. `torch.argmin` returns the first
minimal index, as `jnp.argmin` does; the rotation histogram's top-3 uses the
stable top-k of ops/select.py.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from slam_framework_torch.ops.brief import fmod_positive
from slam_framework_torch.ops.select import top_k

BIG = 1 << 20  # sentinel distance for gated-out pairs (must exceed 256)

HISTO_LENGTH = 30  # orb_matcher.cpp:7


class MatchResult(NamedTuple):
    idx: torch.Tensor    # (N,) int32 — matched column per row, -1 if none
    dist: torch.Tensor   # (N,) int32 — Hamming distance of the match (BIG if none)
    valid: torch.Tensor  # (N,) bool

    @property
    def count(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)


def _minus_one(like: torch.Tensor) -> torch.Tensor:
    return torch.full_like(like, -1)


def gated_match(
    ham: torch.Tensor,
    gate: Optional[torch.Tensor] = None,
    max_dist: int = 256,
    nn_ratio: Optional[float] = None,
    mutual: bool = False,
) -> MatchResult:
    """Masked best match per row of a Hamming matrix (see the reference for
    the threshold / nn-ratio / mutual-best semantics)."""
    d = ham if gate is None else torch.where(gate, ham, torch.full_like(ham, BIG))
    best_d, best_j = torch.min(d, dim=1)
    best_j = best_j.to(torch.int32)
    cols = torch.arange(d.shape[1], dtype=torch.int32, device=d.device)[None, :]
    second_d = torch.where(cols == best_j[:, None], torch.full_like(d, BIG), d).amin(dim=1)

    valid = best_d <= max_dist
    if nn_ratio is not None:
        valid &= best_d.to(torch.float32) < nn_ratio * second_d.to(torch.float32)
    if mutual:
        col_best_i = torch.argmin(d, dim=0).to(torch.int32)
        valid &= col_best_i[best_j.long()] == torch.arange(d.shape[0], dtype=torch.int32, device=d.device)
    idx = torch.where(valid, best_j, _minus_one(best_j))
    return MatchResult(idx=idx, dist=best_d, valid=valid)


def resolve_duplicate_columns(res: MatchResult, num_cols: int) -> MatchResult:
    """Keep only the lowest-distance row per matched column (lowest row wins ties)."""
    rows_n = res.idx.shape[0]
    cols = torch.arange(num_cols, dtype=torch.int32, device=res.idx.device)
    chose = res.valid[:, None] & (res.idx[:, None] == cols[None, :])
    d = torch.where(chose, res.dist[:, None], torch.full_like(chose, BIG, dtype=res.dist.dtype))
    col_min, col_row = torch.min(d, dim=0)
    safe_j = torch.where(res.valid, res.idx, torch.zeros_like(res.idx)).long()
    winner = res.valid & (col_row[safe_j] == torch.arange(rows_n, device=res.idx.device)) & (
        col_min[safe_j] < BIG
    )
    return MatchResult(idx=torch.where(winner, res.idx, _minus_one(res.idx)), dist=res.dist, valid=winner)


def rotation_consistency(angle_a: torch.Tensor, angle_b: torch.Tensor, res: MatchResult) -> MatchResult:
    """Keep matches whose orientation delta falls in the 3 dominant histogram
    bins (ComputeThreeMaxima, orb_matcher.cpp:1584-1625)."""
    safe_j = torch.where(res.valid, res.idx, torch.zeros_like(res.idx)).long()
    two_pi = 2.0 * math.pi
    delta = fmod_positive(angle_a - angle_b[safe_j], two_pi)
    bins = torch.clamp((delta * (HISTO_LENGTH / two_pi)).to(torch.int32), 0, HISTO_LENGTH - 1)
    onehot = bins[:, None] == torch.arange(HISTO_LENGTH, dtype=torch.int32, device=bins.device)[None, :]
    hist = (onehot & res.valid[:, None]).sum(dim=0, dtype=torch.int32)
    top3_vals, top3_idx = top_k(hist, 3)
    top3 = top3_vals.to(torch.float32)
    keep_bin2 = top3[1] >= 0.1 * top3[0]
    keep_bin3 = top3[2] >= 0.1 * top3[0]
    ok = (bins == top3_idx[0]) | ((bins == top3_idx[1]) & keep_bin2) | ((bins == top3_idx[2]) & keep_bin3)
    valid = res.valid & ok
    return MatchResult(idx=torch.where(valid, res.idx, _minus_one(res.idx)), dist=res.dist, valid=valid)


def window_gate(pred_uv: torch.Tensor, feat_uv: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """(N, M) gate: feature j within a square window of radius_i around prediction i."""
    du = torch.abs(pred_uv[:, None, 0] - feat_uv[None, :, 0])
    dv = torch.abs(pred_uv[:, None, 1] - feat_uv[None, :, 1])
    r = radius[:, None] if radius.dim() == 1 else radius
    return (du < r) & (dv < r)


def octave_gate(pred_octave: torch.Tensor, feat_octave: torch.Tensor,
                min_delta: int = -1, max_delta: int = 1) -> torch.Tensor:
    """(N, M) gate on pyramid-level agreement."""
    d = feat_octave[None, :] - pred_octave[:, None]
    return (d >= min_delta) & (d <= max_delta)
