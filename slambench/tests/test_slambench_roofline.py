"""The FAST+NMS kernel's work count and bound, against the figures the port's
PERF.md gives for one frame (16 images stereo, 8 monocular)."""

import pytest

from slambench import roofline


@pytest.mark.parametrize("images,pixels,bound_ms", [(2, 2_888_194, 0.00888), (1, 1_444_097, 0.00444)])
def test_fast_work_and_bound(images, pixels, bound_ms):
    px = roofline.pyramid_pixels(376, 1241, 8, 1.2, images)
    assert px == pixels
    seconds, by = roofline.fast_nms_bound_s(px)
    assert by == "operations"
    assert seconds * 1e3 == pytest.approx(bound_ms, abs=5e-6)
    assert px * roofline.FAST_BYTES_PER_PIXEL / roofline.H100_BYTES_PER_S < seconds
