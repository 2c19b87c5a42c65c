"""Intensity-centroid keypoint orientation from pre-gathered windows.

Port of slam_framework_tpu/ops/orient.py (`ic_angles_from_windows`): moments
m10/m01 of the 31x31 circular patch, angle = atan2(m01, m10).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

HALF_PATCH = 15
PATCH = 2 * HALF_PATCH + 1  # 31


@functools.lru_cache(maxsize=1)
def _disk_masks():
    """(31,31) xw, yw weight maps: coordinate * inside-circular-patch indicator,
    with the reference's u_max row extents (orb_extractor.cpp:969-983)."""
    ys, xs = np.mgrid[-HALF_PATCH: HALF_PATCH + 1, -HALF_PATCH: HALF_PATCH + 1]
    vmax = int(np.floor(HALF_PATCH * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF_PATCH * np.sqrt(2.0) / 2))
    umax = np.zeros(HALF_PATCH + 1, dtype=np.int64)
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(HALF_PATCH**2 - v**2)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    inside = np.abs(xs) <= umax[np.abs(ys)]
    return (xs * inside).astype(np.float32), (ys * inside).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _disk_masks_embedded(side: int, off: int, device: torch.device):
    """(side, side) weight maps with the 31x31 disk embedded at row/col `off`."""
    xw, yw = _disk_masks()
    out_x = np.zeros((side, side), np.float32)
    out_y = np.zeros((side, side), np.float32)
    out_x[off: off + PATCH, off: off + PATCH] = xw
    out_y[off: off + PATCH, off: off + PATCH] = yw
    return torch.from_numpy(out_x).to(device), torch.from_numpy(out_y).to(device)


def ic_angles_from_windows(wins: torch.Tensor, off: int) -> torch.Tensor:
    """Orientation (radians) from (N, side, side) windows whose row/col 0 is
    keypoint offset -(15 + off)."""
    xw, yw = _disk_masks_embedded(wins.shape[-1], off, wins.device)
    m10 = torch.sum(wins * xw[None], dim=(1, 2))
    m01 = torch.sum(wins * yw[None], dim=(1, 2))
    return torch.atan2(m01, m10)
