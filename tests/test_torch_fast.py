"""Parity of the port's FAST+NMS (plain version and CUDA-kernel wrapper) with the
reference's ops/fast.py and its Pallas kernel.

Tolerance: none. Strength and NMS are differences, min, max and comparisons of
the same fp32 values, so every version must agree bit for bit. The Pallas
kernel wraps columns within 4 px of the border, so it is compared after
mask_border(., 16), as the extractor uses it.

The CUDA kernel folds the arcs in another order than the plain version (eight
shared windows of 8 over the raw circle pixels, the centre subtracted last),
and on order-preserving integer keys of the fp32 values. min and max of the
same values in another order select the same values, and rounding is monotone,
so the maps stay bit-equal; the one difference possible is +0.0 against -0.0,
which compares equal. `_kernel_fold` below repeats the kernel's arithmetic in
numpy so that the identity is checked here too.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slam_framework_tpu.ops import fast as jfast
from slam_framework_tpu.ops import fast_pallas
from slam_framework_torch.ops import fast, fast_cuda, pyramid

# level shapes of a 1241x376 image over 8 levels at scale 1.2
KITTI_LEVELS = [(376, 1241), (313, 1034), (261, 862), (218, 718), (181, 598), (151, 499),
                (126, 416), (105, 346)]


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



def test_levels_match_reference_and_pallas_kernel_level_by_level():
    img = torch.from_numpy(_image((96, 160), 13))
    levels = pyramid.build_pyramid(img, 4, 1.2)
    got = fast_cuda.fast_nms_strength_levels(levels)
    assert [tuple(g.shape) for g in got] == [tuple(l.shape) for l in levels]
    for g, lvl in zip(got, levels):
        j = jnp.asarray(lvl.numpy())
        np.testing.assert_array_equal(g.numpy(), np.asarray(jfast.nms3x3(jfast.fast_strength_map(j))))
        np.testing.assert_array_equal(
            fast.mask_border(g, 16).numpy(),
            np.asarray(jfast.mask_border(fast_pallas.fast_nms_strength(j), 16)))
    assert fast_cuda.fast_nms_strength_levels([]) == []


def test_levels_reject_mixed_and_unsupported_devices():
    with pytest.raises(ValueError):
        fast_cuda.fast_nms_strength_levels([torch.zeros(8, 8), torch.empty(8, 8, device="meta")])
    with pytest.raises(ValueError):
        fast_cuda.fast_nms_strength_levels([torch.empty(8, 8, device="meta")])


@pytest.mark.parametrize("shapes", [
    KITTI_LEVELS * 2,
    [(7, 5)],
    [(3, 200), (200, 3), (fast_cuda.TILE_H, fast_cuda.TILE_W), (fast_cuda.TILE_H + 1, fast_cuda.TILE_W + 1)],
    KITTI_LEVELS + [(7, 5), (1, 1)] + KITTI_LEVELS,
])
def test_tile_table_covers_every_pixel_once(shapes):
    table, n_tiles = fast_cuda.tile_table(shapes)
    assert table.dtype.itemsize == 32 and len(table) == len(shapes)
    counts = [t["tiles_x"] * -(-h // fast_cuda.TILE_H) for t, (h, _) in zip(table, shapes)]
    assert n_tiles == sum(counts)
    np.testing.assert_array_equal(table["first_tile"], np.cumsum([0] + counts[:-1]))
    cover = [np.zeros(s, np.int32) for s in shapes]
    for tile in range(n_tiles):
        # as a block finds its image and its tile
        i = 0
        while i + 1 < len(table) and tile >= table["first_tile"][i + 1]:
            i += 1
        ty, tx = divmod(tile - int(table["first_tile"][i]), int(table["tiles_x"][i]))
        y0, x0 = ty * fast_cuda.TILE_H, tx * fast_cuda.TILE_W
        assert y0 < shapes[i][0] and x0 < shapes[i][1]
        cover[i][y0:y0 + fast_cuda.TILE_H, x0:x0 + fast_cuda.TILE_W] += 1
    assert all((c == 1).all() for c in cover)
    assert (table["height"].tolist(), table["width"].tolist()) == tuple(map(list, zip(*shapes)))


def test_output_plan_keeps_images_apart_and_aligned():
    shapes = tuple(KITTI_LEVELS * 2 + [(7, 5), (1, 1)])
    chunks, offsets, total = fast_cuda._plan(shapes)
    assert len(chunks) == 1 and len(offsets) == len(shapes)
    sizes = np.array([h * w for h, w in shapes])
    assert (offsets % 32 == 0).all()
    assert (offsets[1:] >= offsets[:-1] + sizes[:-1]).all() and total == offsets[-1] + sizes[-1]
    assert len(fast_cuda._plan(((8, 8),) * (fast_cuda.MAX_IMAGES + 1))[0]) == 2


def _ordered(bits):
    """The kernel's order-preserving map between fp32 bit patterns and int32."""
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def _kernel_fold(img):
    """The kernel's arithmetic in numpy: integer keys of the raw circle pixels,
    arcs folded by eight windows of 8 starting at the odd positions, the three
    results mapped back and the centre subtracted last."""
    h, w = img.shape
    pad = _ordered(np.pad(img, 3, mode="edge").view(np.int32))
    a = [pad[3 + dy: 3 + dy + h, 3 + dx: 3 + dx + w] for dy, dx in fast.CIRCLE]
    lo = [np.minimum(a[2 * i + 1], a[(2 * i + 2) % 16]) for i in range(8)]
    hi = [np.maximum(a[2 * i + 1], a[(2 * i + 2) % 16]) for i in range(8)]
    arc_lo, arc_hi = [], []
    for i in range(8):
        before, after = a[2 * i], a[(2 * i + 9) % 16]
        arc_lo.append(np.minimum.reduce([lo[(i + j) % 8] for j in range(4)] + [np.maximum(before, after)]))
        arc_hi.append(np.maximum.reduce([hi[(i + j) % 8] for j in range(4)] + [np.minimum(before, after)]))
    bright = _ordered(np.maximum.reduce(arc_lo)).view(np.float32)
    dark = _ordered(np.minimum.reduce(arc_hi)).view(np.float32)
    return np.maximum(bright - img, img - dark)


@pytest.mark.parametrize("shape,integer,shift", [((75, 140), True, 0.0), ((61, 99), False, 0.0),
                                                 ((61, 99), False, -47.3)])
def test_kernel_arc_fold_equals_plain_strength(shape, integer, shift):
    img = _image(shape, 17, integer) + np.float32(shift)  # the shift makes half the pixels negative
    img[::7, ::5] = 0.0
    img[3::7, 2::5] = -0.0
    x = np.linspace(-3.0, 3.0, 9, dtype=np.float32)
    np.testing.assert_array_equal(np.argsort(_ordered(x.view(np.int32)), kind="stable"), np.arange(9))
    np.testing.assert_array_equal(_kernel_fold(img), fast.fast_strength_map(torch.from_numpy(img)).numpy())
