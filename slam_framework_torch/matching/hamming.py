"""Hamming distance between packed 256-bit ORB descriptors, as a matrix product.

Port of slam_framework_tpu/matching/hamming.py. With a, b as 0/1 bit vectors,
H(a, b) = |a| + |b| - 2 <a, b>, so the all-pairs matrix is one fp32 matmul of
unpacked bits (exact: every partial sum is an integer <= 256). Descriptors
are (N, 8) int32 words (see ops/brief.py).
"""

from __future__ import annotations

import torch


def unpack_to_bits(desc: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 words -> (N, 256) fp32 in {0, 1}."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[:, :, None] >> shifts) & 1
    return bits.reshape(desc.shape[0], 256).to(torch.float32)


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distance: (N, 8), (M, 8) -> (N, M) int32 in [0, 256]."""
    a = unpack_to_bits(desc_a)
    b = unpack_to_bits(desc_b)
    dots = torch.matmul(a, b.T)
    return (a.sum(dim=-1)[:, None] + b.sum(dim=-1)[None, :] - 2.0 * dots).to(torch.int32)
