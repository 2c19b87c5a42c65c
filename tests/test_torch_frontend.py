"""Parity of the port's front-end with the reference: the cv2-free renderer,
pyramid, cell selection, orientation, rBRIEF, the extractor, stereo matching
and StereoFrontend, at 640x240 with 800 features on 4 levels.

Each stage is fed the reference's own inputs, so a float difference in one
stage cannot compound into the next. Tolerances, with their reasons:
  - renderer: poses and timestamps identical; mean |pixel difference| below
    0.5 grey levels (OpenCV's stamp rasterisation is emulated, not copied;
    only stamp-edge texels differ);
  - pyramid levels: 1e-3 grey levels (the same fp32 operators, products
    summed in another order);
  - selection, windows, keypoints: identical (exact gathers and a stable
    top-k over the same scores);
  - angles: 1e-4 rad (fp32 moment sums in another order);
  - descriptors: bit-exact given the same windows and angles;
  - u_right: within 1e-3 px, depth within 1e-4 relative, for the same matches.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from slam_framework_tpu.config import CameraConfig as JCam, CapacityConfig as JCap, OrbConfig as JOrb
from slam_framework_tpu.config import SlamConfig as JCfg
from slam_framework_tpu.io import synthetic as jsyn
from slam_framework_tpu.ops import brief as jbrief, extractor as jext, fast as jfast
from slam_framework_tpu.ops import orient as jorient, pyramid as jpyr, select as jsel
from slam_framework_tpu.ops import stereo_match as jstereo
from slam_framework_tpu.pipeline.frame import StereoFrontend as JFront
from slam_framework_torch import config as tconf, interop
from slam_framework_torch.io import synthetic as tsyn
from slam_framework_torch.ops import brief as tbrief, extractor as text, orient as torient
from slam_framework_torch.ops import pyramid as tpyr, select as tsel, stereo_match as tstereo
from slam_framework_torch.pipeline.frame import StereoFrontend as TFront

CAM = dict(fx=400.0, fy=400.0, cx=320.0, cy=120.0, width=640, height=240, fps=10.0, bf=400.0 * 0.54)
CAP = dict(max_keyframes=64, max_map_points=65536, max_features=1024, local_window_points=8192)
WORLD = dict(num_frames=30, seed=1, speed=0.8, yaw_rate=0.004, num_landmarks=2500)


@pytest.fixture(scope="module")
def cfgs():
    j = JCfg(camera=JCam(**CAM), orb=JOrb(num_features=800, num_levels=4), capacity=JCap(**CAP))
    t = tconf.SlamConfig(camera=tconf.CameraConfig(**CAM), orb=tconf.OrbConfig(num_features=800, num_levels=4),
                         capacity=tconf.CapacityConfig(**CAP))
    return j, t


@pytest.fixture(scope="module")
def worlds(cfgs):
    return jsyn.make_world(cam=cfgs[0].camera, **WORLD), tsyn.make_world(cam=cfgs[1].camera, **WORLD)


@pytest.fixture(scope="module")
def frame(worlds):
    """Frame 7 of the port-rendered world (both packages see these pixels)."""
    return worlds[1].stereo_pair(7)


@pytest.fixture(scope="module")
def jpyramids(cfgs, frame):
    img = jnp.asarray(frame[0].astype(np.float32))
    return (jpyr.build_pyramid(img, 4, 1.2), jpyr.build_blurred_pyramid(img, 4, 1.2))


def test_renderer_matches_reference_world(worlds):
    jw, tw = worlds
    np.testing.assert_array_equal(tw.poses, jw.poses)
    np.testing.assert_array_equal(tw.timestamps, jw.timestamps)
    for f in (0, 11, 29):
        for a, b in zip(jw.stereo_pair(f), tw.stereo_pair(f)):
            assert a.shape == b.shape and b.dtype == np.uint8
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).mean() < 0.5


def test_pyramids_match_reference(frame, jpyramids):
    img = torch.from_numpy(frame[0].astype(np.float32))
    for got, want in zip(tpyr.build_pyramid(img, 4, 1.2) + tpyr.build_blurred_pyramid(img, 4, 1.2),
                         jpyramids[0] + jpyramids[1]):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)


@pytest.mark.parametrize("level", [0, 2])
def test_select_uniform_identical(jpyramids, level):
    lvl = jpyramids[0][level]
    s = jfast.mask_border(jfast.nms3x3(jfast.fast_strength_map(lvl)), 16)
    hi, lo = jnp.where(s > 20.0, s, 0.0), jnp.where(s > 7.0, s, 0.0)
    want = jsel.select_uniform(hi, lo, 200, cell=32)
    got = tsel.select_uniform(torch.from_numpy(np.array(hi)), torch.from_numpy(np.array(lo)), 200, cell=32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got.valid.sum()) > 50


def test_windows_angles_and_descriptors(jpyramids):
    lvl, blur = jpyramids[0][0], jpyramids[1][0]
    rng = np.random.default_rng(3)
    xy = np.stack([rng.integers(0, 640, 300), rng.integers(0, 240, 300)], 1).astype(np.int32)
    xy[:5] = [[0, 0], [639, 239], [700, 300], [3, 250], [-4, 10]]  # edges and out-of-range starts
    jw = np.asarray(jbrief.fused_windows(lvl, blur, jnp.asarray(xy)))
    tw = tbrief.fused_windows(torch.from_numpy(np.array(lvl)), torch.from_numpy(np.array(blur)),
                              torch.from_numpy(xy))
    np.testing.assert_array_equal(tw.numpy(), jw)
    off = jbrief.MAX_ROTATED_OFFSET - jorient.HALF_PATCH
    ja = np.asarray(jorient.ic_angles_from_windows(jnp.asarray(jw[..., 0]), off))
    ta = torient.ic_angles_from_windows(torch.from_numpy(jw[..., 0].copy()), off).numpy()
    np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-4)
    flat = jw[..., 1].reshape(300, -1)
    angles = np.concatenate([ja, np.float32([0.0, np.pi, -np.pi, 2 * np.pi, 1e-7])]).astype(np.float32)
    flat = np.concatenate([flat, flat[:5]])
    want = np.asarray(jbrief.descriptors_from_windows(jnp.asarray(flat), jnp.asarray(angles)))
    got = tbrief.descriptors_from_windows(torch.from_numpy(flat), torch.from_numpy(angles))
    np.testing.assert_array_equal(interop.to_numpy(got, uint32=True), want)


def test_extractor_given_reference_pyramid(cfgs, jpyramids):
    jcfg, tcfg = cfgs
    want = jax.device_get(jax.jit(jext.OrbExtractor(jcfg.orb, max_features=1024)._extract_from_pyramid)(*jpyramids))
    got = text.OrbExtractor(tcfg.orb, max_features=1024).extract_from_pyramid(
        [torch.from_numpy(np.array(a)) for a in jpyramids[0]], [torch.from_numpy(np.array(a)) for a in jpyramids[1]])
    for name in ("xy", "response", "octave", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    np.testing.assert_allclose(got.angle.numpy(), want.angle, rtol=0, atol=1e-4)
    # descriptors are bit-exact wherever the angle falls in the same rotation bin
    tau = 2 * np.pi
    same_bin = (np.round(np.mod(got.angle.numpy(), tau) * 64 / tau) % 64
                == np.round(np.mod(want.angle, tau) * 64 / tau) % 64)
    assert same_bin.mean() > 0.99
    np.testing.assert_array_equal(interop.to_numpy(got.desc, uint32=True)[same_bin], want.desc[same_bin])


def test_stereo_match_given_reference_features(cfgs, frame):
    jcfg = cfgs[0]
    ext = jext.OrbExtractor(jcfg.orb, max_features=1024)
    jl, jr = (jnp.asarray(a.astype(np.float32)) for a in frame)
    lp, rp = jpyr.build_pyramid(jl, 4, 1.2), jpyr.build_pyramid(jr, 4, 1.2)
    extract = jax.jit(ext._extract_from_pyramid)
    fl = extract(lp, jpyr.build_blurred_pyramid(jl, 4, 1.2))
    fr = extract(rp, jpyr.build_blurred_pyramid(jr, 4, 1.2))
    jK = JFront(jcfg).K
    want = jax.device_get(jax.jit(lambda a, b, c, d: jstereo.match_stereo(a, b, c, d, jK, ext.scales))(fl, fr, lp, rp))
    to_t = lambda f: text.Features(*[interop.to_tensor(x) for x in jax.device_get(f)])  # noqa: E731
    got = tstereo.match_stereo(to_t(fl), to_t(fr), [interop.to_tensor(a) for a in lp],
                               [interop.to_tensor(a) for a in rp], TFront(cfgs[1]).K, ext.scales)
    ur, d = got.u_right.numpy(), got.depth.numpy()
    np.testing.assert_array_equal(ur >= 0, want.u_right >= 0)
    np.testing.assert_allclose(ur, want.u_right, rtol=0, atol=1e-3)
    np.testing.assert_allclose(d, want.depth, rtol=1e-4, atol=1e-5)
    assert (ur >= 0).sum() > 200


def test_stereo_frontend_end_to_end(cfgs, frame):
    want = jax.device_get(JFront(cfgs[0])(jnp.asarray(frame[0]), jnp.asarray(frame[1])))
    got = TFront(cfgs[1])(torch.from_numpy(frame[0]), torch.from_numpy(frame[1]))
    for name in ("xy", "octave", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    # the blurred levels differ by fp32 rounding, which flips BRIEF comparisons
    # between near-equal samples in a few descriptors (about 4% of rows here)
    same = (interop.to_numpy(got.desc, uint32=True) == want.desc).all(axis=1)
    assert same.mean() > 0.9
    both = (got.u_right.numpy() >= 0) & (want.u_right >= 0)
    assert both.sum() > 0.95 * (want.u_right >= 0).sum()
    np.testing.assert_allclose(got.u_right.numpy()[both], want.u_right[both], rtol=0, atol=1e-3)
