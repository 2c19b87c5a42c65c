"""Image pyramid + pre-BRIEF Gaussian blur as fp32 matrix products.

Port of slam_framework_tpu/ops/pyramid.py. The per-level operators are the
reference's host-composed float64 -> fp32 matrices (`_composed_level_matrices`,
`_composed_blur_matrices`, copied verbatim below): level_l = M_l @ img @ N_l.T.
The products are plain `torch.matmul` in full fp32, as the reference leaves
them to XLA at Precision.HIGHEST.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np
import torch


def level_shapes(height: int, width: int, num_levels: int, scale_factor: float):
    """Static per-level (H, W). Matches the reference's round(dim / scale^l)."""
    shapes = []
    for lvl in range(num_levels):
        inv = 1.0 / (scale_factor**lvl)
        shapes.append((int(round(height * inv)), int(round(width * inv))))
    return shapes


@functools.lru_cache(maxsize=64)
def _interp_matrix(n_in: int, n_out: int):
    """(n_out, n_in) fp32 bilinear interpolation matrix with half-pixel centers
    (same sampling as jax.image.resize(method='linear') / OpenCV INTER_LINEAR).

    numpy, not jnp: cached constants must not capture tracers.
    """
    scale = n_in / n_out
    src = (np.arange(n_out) + 0.5) * scale - 0.5
    src = np.clip(src, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    w_hi = (src - lo).astype(np.float32)
    M = np.zeros((n_out, n_in), np.float32)
    M[np.arange(n_out), lo] += 1.0 - w_hi
    M[np.arange(n_out), hi] += w_hi
    return M


@functools.lru_cache(maxsize=16)
def _composed_level_matrices(height: int, width: int, num_levels: int, scale_factor: float):
    """Per-level (M_l, N_l) fp32 matrices with level_l = M_l @ img @ N_l.T.

    The cascade level_l = resize(level_{l-1}) is a chain of linear maps, so the
    per-level operator is the PRECOMPOSED product of the cascade's interpolation
    matrices — numerically the same low-pass behavior as resizing level-by-level
    (the reference's ComputePyramid, orb_extractor.cpp:1051-1076), but every
    level becomes one independent pair of matmuls straight from the level-0
    image: no serial dependence between levels, and XLA schedules all levels
    concurrently on the MXU. Composed in float64 on host, cast to fp32 once.
    """
    shapes = level_shapes(height, width, num_levels, scale_factor)
    mats = [(None, None)]  # level 0 is the identity
    Mr = np.eye(height, dtype=np.float64)
    Nc = np.eye(width, dtype=np.float64)
    for lvl in range(1, num_levels):
        ph, pw = shapes[lvl - 1]
        h, w = shapes[lvl]
        Mr = _interp_matrix(ph, h).astype(np.float64) @ Mr
        Nc = _interp_matrix(pw, w).astype(np.float64) @ Nc
        mats.append((Mr.astype(np.float32), Nc.astype(np.float32)))
    return mats


@functools.lru_cache(maxsize=16)
def _composed_blur_matrices(
    height: int, width: int, num_levels: int, scale_factor: float,
    ksize: int = 7, sigma: float = 2.0,
):
    """Per-level (B_r @ M_l, B_c @ N_l): resize-then-blur fused into one pair of
    matrices per level, so the pre-BRIEF Gaussian (orb_extractor.cpp:1030) costs
    no separate pass over the pyramid."""
    shapes = level_shapes(height, width, num_levels, scale_factor)
    resize = _composed_level_matrices(height, width, num_levels, scale_factor)
    mats = []
    for lvl in range(num_levels):
        h, w = shapes[lvl]
        Br = _blur_matrix(h, ksize, sigma).astype(np.float64)
        Bc = _blur_matrix(w, ksize, sigma).astype(np.float64)
        if lvl == 0:
            mats.append((Br.astype(np.float32), Bc.astype(np.float32)))
        else:
            M, N = resize[lvl]
            mats.append(
                (
                    (Br @ M.astype(np.float64)).astype(np.float32),
                    (Bc @ N.astype(np.float64)).astype(np.float32),
                )
            )
    return mats


@functools.lru_cache(maxsize=8)
def _gauss_kernel(ksize: int, sigma: float):
    """1D Gaussian taps matching cv2.getGaussianKernel."""
    ax = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-(ax**2) / (2.0 * sigma**2))
    k = k / k.sum()
    # numpy, not jnp: jnp constants made under a jit trace would leak via the cache
    return k.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _blur_matrix(n: int, ksize: int, sigma: float):
    """(n, n) fp32 banded Toeplitz matrix applying a 1D Gaussian with replicate
    padding. numpy, not jnp: cached constants must not capture tracers."""
    k = _gauss_kernel(ksize, sigma)
    pad = ksize // 2
    M = np.zeros((n, n), np.float32)
    for i in range(n):
        for j, kv in enumerate(k):
            M[i, min(max(i + j - pad, 0), n - 1)] += kv
    return M


def scale_factors(num_levels: int, scale_factor: float) -> np.ndarray:
    return np.asarray([scale_factor**l for l in range(num_levels)], dtype=np.float32)


def features_per_level(num_features: int, num_levels: int, scale_factor: float) -> Sequence[int]:
    """Geometric feature budget per level (reference: orb_extractor.cpp ctor logic):
    n_l proportional to (1/scale)^l, remainder to the last level."""
    f = 1.0 / scale_factor
    n0 = num_features * (1.0 - f) / (1.0 - f**num_levels)
    counts = []
    total = 0
    for lvl in range(num_levels - 1):
        c = int(round(n0 * (f**lvl)))
        counts.append(c)
        total += c
    counts.append(max(num_features - total, 0))
    return counts


@functools.lru_cache(maxsize=32)
def _device_level_mats(height: int, width: int, num_levels: int, scale_factor: float, device: torch.device):
    mats = _composed_level_matrices(height, width, num_levels, scale_factor)
    return [None] + [(torch.from_numpy(M).to(device), torch.from_numpy(N.T.copy()).to(device))
                     for M, N in mats[1:]]


@functools.lru_cache(maxsize=32)
def _device_blur_mats(height: int, width: int, num_levels: int, scale_factor: float, device: torch.device):
    mats = _composed_blur_matrices(height, width, num_levels, scale_factor)
    return [(torch.from_numpy(M).to(device), torch.from_numpy(N.T.copy()).to(device)) for M, N in mats]


def build_pyramid(img: torch.Tensor, num_levels: int, scale_factor: float) -> List[torch.Tensor]:
    """img (H, W) fp32 -> list of per-level fp32 tensors, level 0 == img; every
    level is computed straight from level 0 with its precomposed operator."""
    mats = _device_level_mats(img.shape[0], img.shape[1], num_levels, scale_factor, img.device)
    return [img] + [torch.matmul(torch.matmul(M, img), Nt) for M, Nt in mats[1:]]


def build_blurred_pyramid(img: torch.Tensor, num_levels: int, scale_factor: float) -> List[torch.Tensor]:
    """Gaussian-blurred (7x7, sigma 2) levels from the fused resize+blur operators."""
    mats = _device_blur_mats(img.shape[0], img.shape[1], num_levels, scale_factor, img.device)
    return [torch.matmul(torch.matmul(M, img), Nt) for M, Nt in mats]
