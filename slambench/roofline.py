"""Published peaks of the card and the work that bounds a kernel's time.

The peaks are NVIDIA's data sheet for the H100 SXM (dense, at the 700 W
limit). FAST+NMS counts its work from the frame's pyramid pixels, whatever
implements it: each pixel is read once and written once as fp32 (8 bytes),
and takes 103 simple fp32 operations (2 subtractions, 94 arc min/max and 1
max for the strength; 4 max, 1 compare and 1 select for the NMS), each of
which fills a lane for one result, half the rate of a fused multiply-add.
"""

from __future__ import annotations

from typing import Tuple

from slambench.reference import level_shapes

H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12                      # an FMA counts as two
H100_FP32_SIMPLE_OPS_PER_S = H100_FP32_FLOPS / 2

FAST_BYTES_PER_PIXEL = 8
FAST_OPS_PER_PIXEL = 103


def pyramid_pixels(height: int, width: int, num_levels: int, scale_factor: float, images: int) -> int:
    """Pixels of `images` pyramids of a frame (2 for stereo, 1 monocular)."""
    return images * sum(h * w for h, w in level_shapes(height, width, num_levels, scale_factor))


def bound_s(n_bytes: float, n_ops: float) -> Tuple[float, str]:
    """Least time for the bytes and the simple fp32 operations on the card,
    and which of the two sets it."""
    by_bytes = n_bytes / H100_BYTES_PER_S
    by_ops = n_ops / H100_FP32_SIMPLE_OPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def fast_nms_bound_s(pixels: int) -> Tuple[float, str]:
    return bound_s(pixels * FAST_BYTES_PER_PIXEL, pixels * FAST_OPS_PER_PIXEL)
