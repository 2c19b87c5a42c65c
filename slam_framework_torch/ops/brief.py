"""Rotated BRIEF (rBRIEF) 256-bit descriptors, batched over all keypoints.

Port of slam_framework_tpu/ops/brief.py. The 256-pair sampling pattern is
`orb_pattern.npy` beside this module (OpenCV's `bit_pattern_31_`, a copy of the
reference package's file). Rotation is quantized to ROTATION_BINS precomputed
patterns.

Packing: the reference keeps descriptors as (N, 8) uint32, bit j of word w =
pattern pair w*32 + j. torch has no uint32 shifts on the CPU, so the port
keeps the same 32-bit words as int32: `np.uint32` arrays view as these
tensors bit for bit (`interop.py`).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

MAX_ROTATED_OFFSET = 19  # ceil(13 * sqrt(2)); image must be padded by this for sampling
ROTATION_BINS = 64       # 5.6 deg angle quantization
SIDE = 2 * MAX_ROTATED_OFFSET + 2  # 40

PATTERN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "orb_pattern.npy")


@functools.lru_cache(maxsize=1)
def pattern():
    """(256, 4) int32: x_a, y_a, x_b, y_b sample offsets per descriptor bit."""
    return np.load(PATTERN_PATH)


@functools.lru_cache(maxsize=8)
def _binned_flat_idx(bins: int, side: int, pad: int):
    """(bins, 512) int32 flat within-window sample indices for each quantized
    rotation: [256 'a' samples | 256 'b' samples] (copied from the reference)."""
    p = pattern().astype(np.float64)
    xa, ya, xb, yb = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    tables = []
    for b in range(bins):
        th = 2.0 * np.pi * b / bins
        ca, sa = np.cos(th), np.sin(th)

        def flat(px, py):
            rx = np.round(px * ca - py * sa).astype(np.int64)
            ry = np.round(px * sa + py * ca).astype(np.int64)
            return (ry + pad) * side + (rx + pad)

        tables.append(np.concatenate([flat(xa, ya), flat(xb, yb)]))
    return np.stack(tables).astype(np.int32)


@functools.lru_cache(maxsize=8)
def _device_idx(device: torch.device) -> torch.Tensor:
    idx = _binned_flat_idx(ROTATION_BINS, SIDE, MAX_ROTATED_OFFSET)
    return torch.from_numpy(idx.astype(np.int64)).to(device)


def fmod_positive(x: torch.Tensor, m: float) -> torch.Tensor:
    """x mod m with the sign of m, computed as jnp.mod does (exact fmod, then
    one correction)."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & (r < 0), r + m, r)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) bool -> (N, 8) int32 words, bit j of word w = bits[w*32 + j]."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (bits.reshape(-1, 8, 32).to(torch.int64) << shifts).sum(dim=-1)
    words = torch.where(words >= 2**31, words - 2**32, words)  # uint32 -> int32 bits
    return words.to(torch.int32)


def descriptors_from_windows(flat: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 descriptors from flattened (N, SIDE*SIDE) windows whose
    row/col 0 is keypoint offset -MAX_ROTATED_OFFSET."""
    B = ROTATION_BINS
    tau = 2.0 * np.pi
    binf = torch.round(fmod_positive(angles, tau) * (B / tau)).to(torch.int64) % B
    idx = _device_idx(flat.device)[binf]          # (N, 512) static pattern per bin
    sel = torch.gather(flat, 1, idx)
    return pack_bits(sel[:, :256] < sel[:, 256:])


def slice_windows(planes: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(C, N, h, w) windows of (C, H, W) `planes` with top-left (y0, x0).

    Starts follow jax.lax.dynamic_slice: a negative start counts from the end,
    then every start is clamped so the window fits."""
    H, W = planes.shape[-2:]
    y0, x0 = y0.long(), x0.long()
    y0 = torch.clamp(torch.where(y0 < 0, y0 + H, y0), 0, H - h)
    x0 = torch.clamp(torch.where(x0 < 0, x0 + W, x0), 0, W - w)
    rows = (y0[:, None] + torch.arange(h, device=planes.device))[:, :, None]
    cols = (x0[:, None] + torch.arange(w, device=planes.device))[:, None, :]
    return planes[:, rows, cols]


def gather_windows(img: torch.Tensor, xy: torch.Tensor, side: int, pad: int,
                   start_off: int) -> torch.Tensor:
    """(N, side, side[, C]) windows of `img` (H, W[, C]) edge-padded by `pad`,
    starting at padded (y + start_off, x + start_off)."""
    chan = img.dim() == 3
    planes = img.permute(2, 0, 1) if chan else img[None]
    padded = F.pad(planes[None], (pad, pad, pad, pad), mode="replicate")[0]
    wins = slice_windows(padded, xy[:, 1] + start_off, xy[:, 0] + start_off, side, side)
    return wins.permute(1, 2, 3, 0) if chan else wins[0]


def fused_windows(img: torch.Tensor, blur: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """ONE per-keypoint window gather for orientation (channel 0, the raw level)
    and BRIEF (channel 1, the blurred level): (N, SIDE, SIDE, 2), window corner
    at keypoint - MAX_ROTATED_OFFSET."""
    pad = MAX_ROTATED_OFFSET
    return gather_windows(torch.stack([img, blur], dim=-1), xy, SIDE, pad + 1, 1)
