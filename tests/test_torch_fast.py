"""Parity of the port's FAST+NMS (plain version and CUDA-kernel wrapper) with the
reference's ops/fast.py and its Pallas kernel.

Tolerance: none. Strength and NMS are differences, min, max and comparisons of
the same fp32 values, so every version must agree bit for bit. The Pallas
kernel wraps columns within 4 px of the border, so it is compared after
mask_border(., 16), as the extractor uses it.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slam_framework_tpu.ops import fast as jfast
from slam_framework_tpu.ops import fast_pallas
from slam_framework_torch.ops import fast, fast_cuda


def _image(shape, seed, integer=True):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape).astype(np.float32)
    return img if integer else (img * 0.37 + 0.11).astype(np.float32)


@pytest.mark.parametrize(
    "shape,integer",
    [((75, 140), True), ((96, 160), True), ((240, 640), True), ((61, 99), False), ((7, 5), True)],
)
def test_plain_matches_reference_bit_exact(shape, integer):
    img = _image(shape, 11, integer)
    want = np.asarray(jfast.nms3x3(jfast.fast_strength_map(jnp.asarray(img))))
    got = fast_cuda.fast_nms_strength(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, want)


def test_plain_batched_equals_per_image():
    imgs = np.stack([_image((64, 96), s) for s in (1, 2, 3)])
    batched = fast_cuda.fast_nms_strength(torch.from_numpy(imgs)).numpy()
    for i in range(3):
        want = np.asarray(jfast.nms3x3(jfast.fast_strength_map(jnp.asarray(imgs[i]))))
        np.testing.assert_array_equal(batched[i], want)


@pytest.mark.parametrize("shape", [(96, 160), (75, 140)])
def test_plain_matches_pallas_kernel_after_border_mask(shape):
    img = _image(shape, 7)
    want = np.asarray(jfast.mask_border(fast_pallas.fast_nms_strength(jnp.asarray(img)), 16))
    got = fast.mask_border(fast_cuda.fast_nms_strength(torch.from_numpy(img)), 16).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() > 0


def test_mask_border_matches_reference():
    s = _image((50, 70), 5)
    np.testing.assert_array_equal(
        fast.mask_border(torch.from_numpy(s), 16).numpy(), np.asarray(jfast.mask_border(jnp.asarray(s), 16))
    )


def test_cpu_tensor_takes_plain_version_without_counting():
    before = fast_cuda.launches
    fast_cuda.fast_nms_strength(torch.from_numpy(_image((40, 40), 1)))
    assert fast_cuda.launches == before


def test_other_devices_raise():
    with pytest.raises(ValueError):
        fast_cuda.fast_nms_strength(torch.empty(2, 40, 40, device="meta"))


def test_library_is_keyed_on_source_and_flags():
    path = fast_cuda.library_path()
    assert path.startswith(fast_cuda.BUILD_DIR)
    assert "arch=compute_90a,code=sm_90a" in fast_cuda.NVCC_FLAGS
    assert path == fast_cuda.library_path()

