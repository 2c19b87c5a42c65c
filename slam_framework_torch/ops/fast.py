"""FAST-9/16 corner strength + 3x3 NMS as whole-image tensor ops (plain version).

Counterpart of slam_framework_tpu/ops/fast.py, and the plain PyTorch version of
the CUDA kernel in ops/fast_cuda.py: the dense corner-strength map is the
largest threshold at which a pixel is still a FAST-9 corner, i.e. the max over
9-arcs of (min over the arc of the signed difference), bright and dark
branches. One strength map serves both FAST thresholds of the extractor.

All functions take (..., H, W) fp32 tensors and act on the last two axes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 — 16 (dy, dx) offsets, clockwise from 12 o'clock.
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

ARC_LEN = 9  # FAST-9: need 9 contiguous of 16


def _pad(img: torch.Tensor, p: int, mode: str, value: float = 0.0) -> torch.Tensor:
    """Pad the last two axes of (..., H, W) by p on every side."""
    lead = img.shape[:-2]
    flat = img.reshape((-1,) + tuple(img.shape[-2:]))
    if mode == "replicate":
        out = F.pad(flat, (p, p, p, p), mode="replicate")
    else:
        out = F.pad(flat, (p, p, p, p), mode="constant", value=value)
    return out.reshape(lead + tuple(out.shape[-2:]))


def fast_strength_map(img: torch.Tensor) -> torch.Tensor:
    """Dense, threshold-free FAST-9 corner-strength map, (..., H, W) fp32.

    A pixel is a corner at threshold t iff strength > t; reads outside the
    image are edge-replicated."""
    h, w = img.shape[-2:]
    padded = _pad(img, 3, "replicate")
    diffs = torch.stack(
        [padded[..., 3 + dy: 3 + dy + h, 3 + dx: 3 + dx + w] for dy, dx in CIRCLE], dim=0
    ) - img[None]  # (16, ..., H, W)

    def arc_strength(d: torch.Tensor) -> torch.Tensor:
        # sliding circular window-min of width 9 in log steps
        m2 = torch.minimum(d, torch.roll(d, -1, dims=0))
        m4 = torch.minimum(m2, torch.roll(m2, -2, dims=0))
        m8 = torch.minimum(m4, torch.roll(m4, -4, dims=0))
        m9 = torch.minimum(m8, torch.roll(d, -8, dims=0))
        return m9.amax(dim=0)

    return torch.maximum(arc_strength(diffs), arc_strength(-diffs))


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep only pixels that are the strict max of their 3x3 neighbourhood."""
    h, w = score.shape[-2:]
    padded = _pad(score, 1, "constant", float("-inf"))
    neigh = torch.stack(
        [
            padded[..., 1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
            if not (dy == 0 and dx == 0)
        ],
        dim=0,
    )
    keep = score > neigh.amax(dim=0)
    return torch.where(keep, score, torch.zeros_like(score))


def mask_border(score: torch.Tensor, margin: int) -> torch.Tensor:
    """Zero scores within `margin` pixels of the border (the extractor's
    detection-region clamp, EDGE_THRESHOLD - 3 = 16)."""
    h, w = score.shape[-2:]
    out = torch.zeros_like(score)
    out[..., margin: h - margin, margin: w - margin] = score[..., margin: h - margin, margin: w - margin]
    return out
